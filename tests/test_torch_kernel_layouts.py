"""Layouts and shape rules of the bf16 tensor-core kernels, on the CPU: a
model of K1's bf16 recurrence operands (csrc/birnn_tc.cu stages W_hh, W_ih's
slice, x_t and h in shared memory itself, in wgmma's swizzled K-major
layout), held to the kernel source and, through a plain recurrence that
reads those operands as wgmma's descriptors address them, to models/rnn.py;
the planners that pick each kernel's design; and the launch counters, which
a CPU call leaves alone."""

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


def block_unit(ub, i):
    """The CTA-local unit of row i of unit block ub (csrc/birnn_tc.cu's
    b_row, inverted): blocks in pairs 2q + b, row i of block 2q + b is unit
    16q + 4(i // 2) + 2b + i % 2, so the rows 2 t4, 2 t4 + 1 of both blocks
    of a pair (one thread's accumulator columns) are 4 consecutive units."""
    return 16 * (ub >> 1) + 4 * (i >> 1) + 2 * (ub & 1) + (i & 1)


def staged_columns(H, U, cell):
    """(CN, NG*U): the W_hh column that each B row of ``tc_rec_kernel``'s
    W_hh operand holds. Row (ub*NG + gate)*8 + i of CTA c holds column
    gate*H + c*U + block_unit(ub, i), so an 8-column block of the
    accumulators is one gate of 8 units and a thread's accumulators hold
    every gate of its units."""
    ng = n_gates(cell)
    c = torch.arange(H // U).view(-1, 1, 1, 1)
    ub = torch.arange(U // 8).view(1, -1, 1, 1)
    gate = torch.arange(ng).view(1, 1, -1, 1)
    i = torch.arange(8).view(1, 1, 1, -1)
    return (gate * H + c * U + block_unit(ub, i)).reshape(H // U, ng * U)


def kmajor_off(row, kb, wb):
    """csrc/wgmma_tile.cuh's kmajor_off: the byte offset at which the kernel
    stores byte kb of operand row ``row`` in a K-major operand of wb-byte
    rows (8-row atoms, the 16-byte chunks of a row XOR-swizzled)."""
    row, kb = torch.as_tensor(row), torch.as_tensor(kb)
    s = {128: row & 7, 64: (row >> 1) & 3, 32: (row >> 2) & 1}[wb]
    return (row >> 3) * 8 * wb + (row & 7) * wb + ((((kb >> 4) ^ s) << 4) | (kb & 15))


def swizzled(addr, wb):
    """The address that wgmma reads (and TMA writes) for the linear address
    ``addr`` under the wb-byte swizzle: address bits [7, 7 + b) XOR into
    bits [4, 4 + b), 2^b = wb / 16."""
    return addr ^ (((addr >> 7) & (wb // 16 - 1)) << 4)


def stage_kmajor(mat, wb):
    """mat (rows, K) -> a K-major operand image (flat, one slot a bf16) in K
    blocks of wb / 2 k, each rows x wb bytes: the kernel's stores."""
    rows, K = mat.shape
    kblock = wb // 2
    img = torch.zeros((-(-K // kblock)) * rows * wb // 2, dtype=mat.dtype)
    r, k = torch.arange(rows).view(-1, 1), torch.arange(K).view(1, -1)
    img[((k // kblock) * rows * wb + kmajor_off(r, (k % kblock) * 2, wb)) // 2] = mat
    return img


def operand_index(start, rows, K, wb, block_bytes):
    """(rows, K) slots of an image that wgmma reads for K-major operand rows
    [0, rows) over k [0, K), as the kernel issues it: k16 step ks in K block
    ks // (wb / 32) (``block_bytes`` apart) at 32 (ks % (wb / 32)) bytes into
    the row, each a descriptor of start address, SBO = 8 wb and the wb
    swizzle."""
    steps = wb // 32
    r, k = torch.arange(rows).view(-1, 1), torch.arange(16).view(1, -1)
    cols = []
    for ks in range(K // 16):
        s0 = start + (ks // steps) * block_bytes + 32 * (ks % steps)
        cols.append(swizzled(s0 + (r >> 3) * 8 * wb + (r & 7) * wb + 2 * k, wb) // 2)
    return torch.cat(cols, dim=1)


def stage_whh(whh, U, cell):
    """One direction's W_hh (H, G) -> (CN, slots): each CTA's W_hh operand
    image (B rows ``staged_columns``, k along the row, K blocks of 64)."""
    cols = staged_columns(whh.shape[0], U, cell)
    return torch.stack([stage_kmajor(whh.T[c], 128) for c in cols])


def unstage_whh(staged, cell, H):
    """The inverse of ``stage_whh``, through wgmma's reads of the images."""
    cn = staged.shape[0]
    U = H // cn
    nc = n_gates(cell) * U
    idx = operand_index(0, nc, H, 128, nc * 128)
    w = staged.new_empty((n_gates(cell) * H, H))
    w[staged_columns(H, U, cell).reshape(-1)] = torch.cat([img[idx] for img in staged])
    return w.T.contiguous()


def _tc_model(layers, x, compute_dtype, cell, plan):
    """K1-tc's arithmetic in plain PyTorch, in the kernel's operands: per
    layer and direction, each CTA c of the cluster stages its W_hh operand
    (and, when ``tc_fused_kx`` takes the layer's width, W_ih's slice with the
    GRU's n gate apart, and x_t each step); each step, each warpgroup (mr,
    wn) of each CTA reads rows [64 mr, 64 mr + 64) of the h image and B rows
    [wn NW, (wn+1) NW) through ``operand_index`` as the kernel's
    descriptors address them, its accumulators starting from xg (or the
    biases); the gate math on the accumulator columns (gate-interleaved);
    and each CTA stores its units' new h into the h image with
    ``kmajor_off``, inside its own block, which the copies carry whole."""
    L, N, _C = x.shape
    H = layers[0][2].shape[1]
    ng = n_gates(cell)
    U, MR, WN, R = plan["U"], plan["MR"], plan["WN"], plan["rows"]
    cn, upw = H // U, U // plan["WN"]
    nc, nw = ng * U, ng * upw
    kbh = -(-H // 64)
    assert N <= R  # one row tile

    def op(t):
        return t.to(compute_dtype).float()

    h_idx = [operand_index(mr * 64 * 128, 64, H, 128, R * 128) for mr in range(MR)]
    b_idx = [operand_index(wn * nw * 128, nw, H, 128, nc * 128) for wn in range(WN)]
    inp, h_ns = x, []
    for wih, bih, whh, bhh in layers:
        C = inp.shape[2]
        kx = bigru.tc_fused_kx(plan, C, cell, H)
        outs = []
        for d in (0, 1):
            fold = bhh[d].clone()
            if cell == "gru":
                fold[2 * H:] = 0.0
            if kx:
                xg = None
                wbx = 2 * kx
                wx = op(wih[d]).T  # (G, C)
                ws_x, ws_xn = [], []
                for c in range(cn):
                    cols = staged_columns(H, U, cell)[c]
                    bx = torch.zeros((nc, kx))
                    bx[:, :C] = wx[cols]
                    if cell == "gru":
                        bx[(cols >= 2 * H)] = 0.0  # the n gate's x side runs apart
                        bxn = torch.zeros((U, kx))
                        rows = torch.arange(U)
                        bxn[:, :C] = wx[2 * H + c * U + block_unit(rows >> 3, rows & 7)]
                        ws_xn.append(stage_kmajor(bxn, wbx))
                    ws_x.append(stage_kmajor(bx, wbx))
                x_idx = [operand_index(mr * 64 * wbx, 64, kx, wbx, 0) for mr in range(MR)]
                bx_idx = [operand_index(wn * nw * wbx, nw, kx, wbx, 0) for wn in range(WN)]
                bxn_idx = [operand_index(wn * upw * wbx, upw, kx, wbx, 0) for wn in range(WN)]
            else:
                xg = (op(inp).reshape(L * N, -1) @ op(wih[d]) + (bih[d] + fold)).reshape(L, N, ng * H)
            ws = [stage_whh(op(whh[d]), U, cell)[c] for c in range(cn)]
            h_img = torch.zeros(kbh * R * 64)  # the h operand (every CTA's copy is equal)
            h = torch.zeros((R, H))
            c_state = torch.zeros((R, H))
            ys = [None] * L
            for s in range(L):
                t = s if d == 0 else L - 1 - s
                if kx:
                    xt = torch.zeros((R, kx))
                    xt[:N, :C] = op(inp[t])
                    x_img = stage_kmajor(xt, wbx)
                hnew = torch.zeros((R, H))
                cnew = torch.zeros((R, H))
                for c in range(cn):
                    cols = staged_columns(H, U, cell)[c]  # global column of each B row
                    for mr in range(MR):
                        for wn in range(WN):
                            bcols = cols[wn * nw:(wn + 1) * nw]
                            rows = slice(mr * 64, mr * 64 + 64)
                            here = slice(mr * 64, max(mr * 64, min(N, mr * 64 + 64)))
                            nh = here.stop - here.start  # rows of the batch in this block
                            gate, unit = bcols // H, bcols % H
                            if kx:
                                bias = torch.where(gate == 2 if cell == "gru" else gate < 0,
                                                   bhh[d][bcols], bih[d][bcols] + bhh[d][bcols])
                                acc = bias + x_img[x_idx[mr]] @ ws_x[c][bx_idx[wn]].T
                            else:
                                bias = torch.where(gate == 2, bhh[d][bcols], 0.0) \
                                    if cell == "gru" else torch.zeros(nw)
                                acc = torch.zeros((64, nw))
                                acc[:nh] = xg[t, here][:, bcols]
                                if cell == "gru":
                                    acc[:, gate == 2] = 0.0
                                acc = acc + bias
                            acc = acc + h_img[h_idx[mr]] @ ws[c][b_idx[wn]].T
                            units = unit[gate == 0]
                            if cell == "gru":
                                if kx:
                                    xn = bih[d][2 * H + units] + x_img[x_idx[mr]] @ ws_xn[c][bxn_idx[wn]].T
                                else:
                                    xn = torch.zeros((64, len(units)))
                                    xn[:nh] = xg[t, here][:, 2 * H + units]
                                r = torch.sigmoid(acc[:, gate == 0])
                                z = torch.sigmoid(acc[:, gate == 1])
                                n = torch.tanh(xn + r * acc[:, gate == 2])
                                hnew[rows, units] = (1.0 - z) * n + z * h[rows][:, units]
                            else:
                                pre = [acc[:, gate == g] for g in range(4)]
                                cc = torch.sigmoid(pre[1]) * c_state[rows][:, units] + \
                                    torch.sigmoid(pre[0]) * torch.tanh(pre[2])
                                cnew[rows, units] = cc
                                hnew[rows, units] = torch.sigmoid(pre[3]) * torch.tanh(cc)
                # after every CTA's product of the step: CTA c's stores of
                # its units' new h, which land in its own block
                for c in range(cn):
                    k = torch.arange(c * U, (c + 1) * U).view(1, -1)
                    r = torch.arange(R).view(-1, 1)
                    off = (k >> 6) * R * 128 + kmajor_off(r, (k & 63) * 2, 128)
                    if cn > 1:
                        lo = (c * U // 64) * R * 128
                        assert off.min() >= lo and off.max() < lo + (U // 64) * R * 128
                    h_img[off // 2] = op(hnew[:, c * U:(c + 1) * U])
                h, c_state = hnew, cnew
                ys[t] = h[:N]
            h_ns.append(h[:N])
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
    kbh = -(-hidden // 64)
    assert staged.shape == (cn, kbh * ng * U * 64)
    # the B row that the kernel's accumulator block (ub, gate) reads, at k
    idx = operand_index(0, ng * U, hidden, 128, ng * U * 128)
    for c, ub, gate, i in ((0, 0, 0, 0), (cn - 1, U // 8 - 1, ng - 1, 7), (cn // 2, 1, 1, 3)):
        row = staged[c][idx[(ub * ng + gate) * 8 + i]]
        assert torch.equal(row, whh[:, gate * hidden + c * U + block_unit(ub, i)])
    # the two blocks of a pair give thread t4 (rows 2 t4, 2 t4 + 1) the
    # units 16 q + 4 t4 .. + 3, and the blocks cover the CTA's units once
    ub, i = torch.arange(U // 8).view(-1, 1), torch.arange(8).view(1, -1)
    assert sorted(block_unit(ub, i).reshape(-1).tolist()) == list(range(U))
    for q in range(U // 16):
        for t4 in range(4):
            units = [block_unit(2 * q + b, 2 * t4 + e) for b in (0, 1) for e in (0, 1)]
            assert units == [16 * q + 4 * t4 + v for v in range(4)]
    assert torch.equal(unstage_whh(staged, cell, hidden), whh)


@pytest.mark.parametrize("wb", [32, 64, 128])
def test_kernel_stores_are_what_wgmma_reads(wb):
    """kmajor_off (the kernel's stores, from a 1024-byte-aligned base) is
    the swizzle of the linear address that a descriptor reads: every slot of
    an operand of 64 rows is written once and read back as stored."""
    rows, K = 64, wb // 2 * (2 if wb == 128 else 1)
    mat = torch.arange(rows * K, dtype=torch.float32).view(rows, K)
    img = stage_kmajor(mat, wb)
    assert torch.equal(torch.sort(img).values, torch.sort(mat.reshape(-1)).values)
    assert torch.equal(img[operand_index(0, rows, K, wb, rows * wb)], mat)


@pytest.mark.parametrize("C", [11, 28, 52])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("cell", ["gru", "lstm"])
@pytest.mark.parametrize("hidden", HIDDEN)
def test_staged_recurrence_equals_birnn_tm(hidden, cell, dtype, C):
    """Two layers: layer 0 of width C (its projection fused where
    ``tc_fused_kx`` takes it: the 32-, 64- and 128-byte swizzles of the x
    operand at C = 11, 28, 52), layer 1 from xg. fp32 to 1e-5 (sums in
    another order); bf16 to 1e-2, one bf16 ulp on [0.5, 1) plus margin,
    where an f32 sum in another order rounds an activation the other way."""
    dt = getattr(torch, dtype)
    rng = np.random.RandomState(hidden + len(cell) + C)
    layers = [layer_weights(ld, dt) for ld in init_rnn_params(rng, C, hidden, 2, cell)]
    x = torch.from_numpy(rng.randn(21, 5, C).astype(np.float32)).to(dt)
    out, hn = _tc_model(layers, x, dt, cell, bigru.k1_plan(hidden, cell))
    ref_out, ref_hn = birnn_tm(layers, x, None, dt, cell)
    tol = 1e-5 if dt == torch.float32 else 1e-2
    assert out.dtype == ref_out.dtype and hn.shape == ref_hn.shape
    assert (out.float() - ref_out.float()).abs().max().item() <= tol
    assert (hn - ref_hn).abs().max().item() <= tol


def _tc_source():
    srcs = []
    for name in (bigru.TC_SRC, "wgmma_tile.cuh"):
        with open(os.path.join(os.path.dirname(bigru.__file__), "csrc", name)) as f:
            srcs.append(" ".join(f.read().split()))
    return " ".join(srcs)


def test_staging_model_follows_the_kernel_source():
    """The model above is the kernel's: W_hh's B row b_row(NG, u, gate)
    holds column gate*H + u0 + u (``block_unit`` inverts it), K blocks of 64
    k, 128-byte rows; a warpgroup's operands start at its 64 rows and NW B
    rows, a k16 step at 32 bytes into the row; a thread's 4 units of a pair
    and its accumulators; the new h of unit k at K block k / 64; a CTA's
    block starts at its first unit's K block; the swizzles and descriptors;
    the fused x operand's rows of 2 KX bytes and x_t's element stores."""
    src = _tc_source()
    for line in ("const int q = u >> 4, r = u & 15;",
                 "return ((2 * q + ((r >> 1) & 1)) * ng + gate) * 8 + 2 * (r >> 2) + (r & 1);",
                 "stage8x8(ws + (k8 >> 3) * NC * 128, [&](int e) { return b_row(NG, 8 * ub + e, "
                 "gate); }, (k8 & 7) * 16, 128, W + (size_t)k8 * 8 * G + gate * H + u0 + ub * 8, "
                 "G, 8);",
                 "const int col = gate * H + u0 + 16 * (ub >> 1) + 4 * (i >> 1) + 2 * (ub & 1) + "
                 "(i & 1);",
                 "stage8x8(base + sm.bxn, [&](int e) { return b_row(1, 8 * ub + e, 0); }",
                 "const int u0 = crank * U;",
                 "const int uw = u0 + wn * UPW + 4 * t4;",
                 "const int ubw = 2 * pw + (v >> 1), q = 2 * hh + (v & 1);",
                 "Wgmma<NW>::template mma<0>(acc, kmajor_desc(hs + kb * R * 128 + mr * 64 * 128 + "
                 "sub, 128), kmajor_desc(ws + kb * NC * 128 + wn * NW * 128 + sub, 128), 1);",
                 "const uint32_t kb = ks >> 2, sub = (ks & 3) * 32;",
                 "const int k = uw + 16 * pw;",
                 "st_shared_v2(hs + (k >> 6) * R * 128 + kmajor_off(rl0 + 8 * hh, (k & 63) * 2, "
                 "128), hp[pw][hh]);",
                 "const uint32_t src = hs + (u0 >> 6) * R * 128;",
                 "const uint32_t block_bytes = U >= 64 ? (U / 64) * R * 128 : 0;",
                 "const int s = wb == 128 ? (row & 7) : wb == 64 ? ((row >> 1) & 3) : "
                 "((row >> 2) & 1);",
                 "return (uint32_t)((row >> 3) * 8 * wb + (row & 7) * wb + ((((kb >> 4) ^ s) << 4) "
                 "| (kb & 15)));",
                 "((uint64_t)((8 * wb) >> 4) << 32) | (mode << 62);",
                 "const uint32_t xa = base + sm.xs + mr * 64 * wbx;",
                 "kmajor_desc(base + sm.bx + wn * NW * wbx + 32 * kk, wbx)",
                 "kmajor_desc(base + sm.bxn + wn * UPW * wbx + 32 * kk, wbx)",
                 "const int nk = (!LSTM && gate == 2) ? 0 : min(8, C - k8 * 8);",
                 "st_shared_u16(base + sm.xs + kmajor_off(r, 2 * c, wbx), __ldg(src + i));",
                 "const int n0 = (((wn * NUB + 2 * pw) * NG + gate) * 8) + 2 * t4;",
                 "const int a0 = 4 * (2 * pw * NG + gate), a1 = 4 * ((2 * pw + 1) * NG + gate);",
                 "if (row < N) v = ld_nc_f4(xt + (size_t)row * G + gate * H + uw + 16 * pw);"):
        assert line in src, line


def parent_tc_shape(H, cell):
    """The bf16 shapes that took the tc design before its wgmma redesign:
    H % 16 == 0, U the largest of 64, 32, 16 dividing H, a cluster of 1, 2,
    4 or 8 CTAs, (NG U + 128)(H + 8) 2 bytes of shared memory within the
    limit."""
    if H % 16:
        return False
    U = next(u for u in (64, 32, 16) if H % u == 0)
    return (H // U in (1, 2, 4, 8)
            and (n_gates(cell) * U + 128) * (H + 8) * 2 <= SMEM_LIMIT)


@pytest.mark.parametrize("cell", ["gru", "lstm"])
@pytest.mark.parametrize("hidden", HIDDEN + (32, 128))
def test_k1_plan_takes_the_model_shapes(hidden, cell):
    """In bf16 the rule reads H and the cell, not the row count: every row
    count gets the same plan and takes the design it picks (the recurrence
    grid covers ceil(N / rows) row tiles). The geometry is TC_GEOMETRY's at
    H = 256 and TC_BY_U's below, with the kernel's shared-memory formula,
    within the 227 KB."""
    plan = bigru.k1_plan(hidden, cell)
    assert plan["design"] == "tc", plan
    for rows in (1, 1024, bigru.ROWS_CROSSOVER, 16384):
        assert bigru.k1_plan(hidden, cell, torch.bfloat16, rows) == plan
    U, cn = plan["U"], plan["CN"]
    assert U in (16, 32, 64) and U * cn == hidden and cn in (1, 2, 4, 8)
    geo = bigru.TC_GEOMETRY[cell] if hidden == 256 else bigru.TC_BY_U[U]
    assert (U, plan["MR"], plan["WN"]) == geo
    assert plan["rows"] == 64 * plan["MR"] and plan["threads"] == 128 * plan["MR"] * plan["WN"]
    assert plan["smem"] == bigru.tc_smem(hidden, cell, U, plan["rows"]) <= SMEM_LIMIT
    assert (U // plan["WN"]) % 8 == 0 and n_gates(cell) * U // plan["WN"] <= 256


@pytest.mark.parametrize("cell", ["gru", "lstm"])
def test_k1_plan_keeps_every_bf16_shape(cell):
    """Every bf16 H that took tc before the redesign still does, and no
    other H does: nothing newly raises or changes design."""
    for hidden in range(1, 1025):
        plan = bigru.k1_plan(hidden, cell)
        assert (plan["design"] == "tc") == parent_tc_shape(hidden, cell), (hidden, plan)


@pytest.mark.parametrize("hidden,cell,U,cn", [(32, "gru", 32, 1), (128, "lstm", 64, 2),
                                             (128, "gru", 64, 2), (48, "lstm", 16, 3),
                                             (256, "gru", 64, 4), (16, "lstm", 16, 1)])
def test_k1_plan_splits_the_units(hidden, cell, U, cn):
    """U is the largest of 64, 32, 16 that divides H; CN = H / U CTAs a
    cluster, which must be 1, 2, 4 or 8. H = 48 is refused by the simt
    design too (U = 32 does not divide it), so it takes l2."""
    plan = bigru.k1_plan(hidden, cell)
    if cn in (1, 2, 4, 8):
        assert (plan["design"], plan["U"], plan["CN"]) == ("tc", U, cn)
    else:
        assert plan["design"] == "l2" and plan["why"] == "a cluster of {} CTAs".format(cn)


@pytest.mark.parametrize("hidden,cell,widths", [
    (256, "gru", {11: 16, 21: 32, 28: 32, 52: 64, 64: 64, 65: 0, 512: 0}),
    (256, "lstm", {11: 16, 21: 32, 28: 32, 52: 0, 512: 0}),
    (32, "gru", {11: 16, 21: 32, 52: 64}),
    (16, "lstm", {11: 16, 28: 32, 52: 64, 128: 0}),
])
def test_tc_fused_kx(hidden, cell, widths):
    """Layer 0 fuses its projection at C <= 64 where W_ih's slice fits
    beside W_hh and h: the LSTM at H = 256 has no room for the 64-wide one
    (C = 52 keeps the separate projection); the swept GRU geometry of U =
    128 fuses nothing."""
    plan = bigru.k1_plan(hidden, cell)
    for C, kx in widths.items():
        assert bigru.tc_fused_kx(plan, C, cell, hidden) == kx, (C, kx)
        if kx:
            assert bigru.tc_smem(hidden, cell, plan["U"], plan["rows"], kx) <= SMEM_LIMIT
    if hidden == 256 and cell == "gru":
        wide = bigru.tc_geometry(256, "gru", (128, 1, 4))
        assert wide["smem"] <= SMEM_LIMIT and bigru.tc_fused_kx(wide, 11, "gru", 256) == 0


def test_tc_smem_follows_the_kernel_source():
    """``tc_smem`` is csrc/birnn_tc.cu's tc_rec_smem, and the entries check
    the cluster and fused-width rules that ``k1_plan`` and ``tc_fused_kx``
    assume."""
    src = _tc_source()
    for line in ("s.hs = s.ws + kbh * nc * 128;",
                 "s.bx = s.hs + kbh * R * 128;",
                 "s.bxn = s.bx + (KX ? round1024(nc * wbx) : 0);",
                 "s.xs = s.bxn + (KX && ng == 3 ? round1024(U * wbx) : 0);",
                 "s.bars = s.xs + (KX ? round1024(R * wbx) : 0);",
                 "s.binit = s.bars + 16;",
                 "s.bxnb = s.binit + 4 * nc;",
                 "s.total = s.bxnb + 4 * U;",
                 "if (cn != 1 && cn != 2 && cn != 4 && cn != 8) return nullptr;",
                 "if (cn > 1 && U % 64 != 0) return nullptr;",
                 "if (KX != 0 && KX != 16 && KX != 32 && KX != 64) return nullptr;",
                 "*smem = tc_rec_smem(cell ? 4 : 3, H, U, 64 * MR, KX).total;",
                 "#define SMEM_LIMIT 232448"):
        assert line in src, line
    geos = re.findall(r"X\((\d+), (\d+), (\d+)\)", src)
    assert {tuple(int(v) for v in g) for g in geos} >= set(bigru.TC_BY_U.values()) | set(
        bigru.TC_GEOMETRY.values())


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


def _csrc(name):
    path = os.path.join(os.path.dirname(bigru.__file__), "csrc", name)
    with open(path) as f:
        return " ".join(f.read().split())


def simt_geometries(src):
    """{cell: [(U, R), ...]}: the f32 recurrence's instantiations in
    csrc/birnn_simt.cu (its GRU_GEOMETRIES and LSTM_GEOMETRIES lists of (U,
    RT): R = SL RT rows a tile, SL = 128 / (U / 2) row slots)."""
    found = {"gru": [], "lstm": []}
    for lstm, U, RT in re.findall(r"X\((false|true), (\d+), (\d+)\)", src):
        found["lstm" if lstm == "true" else "gru"].append((int(U), 256 // int(U) * int(RT)))
    return found


@pytest.mark.parametrize("cell", ["gru", "lstm"])
@pytest.mark.parametrize("hidden", [16, 32, 64, 128, 256])
def test_k1_plan_simt_geometry_follows_the_kernel_source(hidden, cell):
    """fp32 K1 and K2 run csrc/birnn_simt.cu's own recurrence: the rule's
    geometry is one that the source instantiates for the cell (at H = 256
    the first of its list), with the source's thread count (four product
    warps: U / 2 unit pairs by 256 / U row slots; four gate warps),
    shared-memory formula and layout constraints, within the 227 KB and on
    clusters of 1, 2, 4 or 8 CTAs."""
    src = _simt_source()
    plan = bigru.k1_plan(hidden, cell, torch.float32)
    U, R = plan["U"], plan["rows"]
    geos = simt_geometries(src)[cell]
    assert plan["design"] == "simt" and (U, R) in geos
    if hidden == 256:
        assert (U, R) == geos[0] == bigru.SIMT_GEOMETRY[cell]
    else:
        assert U == min(hidden, 32)
    assert U * plan["CN"] == hidden and plan["CN"] in (1, 2, 4, 8)
    assert "if (cn != 1 && cn != 2 && cn != 4 && cn != 8) return nullptr;" in src
    assert "#define K1_PW 128" in src and "#define K1_THREADS (2 * K1_PW)" in src
    assert "__launch_bounds__(K1_THREADS, 1) birnn_rec_kernel" in src
    assert "static constexpr int UP = U / 2, SL = K1_PW / UP, R = SL * RT;" in src
    assert plan["threads"] == 2 * 128 and (U // 2) * (256 // U) == 128  # a warp on each scheduler
    rt = plan["rows_a_thread"]
    assert rt * (256 // U) == R
    assert "static_assert(UP * SL == K1_PW && U % 16 == 0" in src
    assert U % 16 == 0
    assert "const int rt = R * (U / 2) / K1_PW;" in src
    assert "return ((size_t)H * ng * U + (size_t)H * R + (size_t)rt * ng * K1_PW) * 4 + 32;" in src
    ng = n_gates(cell)
    assert plan["smem"] == (hidden * ng * U + hidden * R + rt * ng * 128) * 4 + 32
    assert plan["smem"] <= SMEM_LIMIT
    assert "(N + R - 1) / R" in src  # clusters a direction


def k1_row(rt, nq, q, i):
    """csrc/rnn_train_rec.cuh's fwd_row: row i (of rt) of the thread in row
    slot q of nq, within the tile: quads of consecutive rows first (quad j:
    rows 4 (j nq + q) ..), then one row a slot."""
    quads = rt // 4 * 4
    return np.where(i < quads, (i // 4 * nq + q) * 4 + i % 4, quads * nq + (i - quads) * nq + q)


def simt_product_tiles(plan, cn):
    """The kernel's product micro-tiles (birnn_rec_kernel's index
    arithmetic): for CTA rank c and product thread t (unit pair up = t % UP,
    row slot q = t / UP), the tile rows k1_row(RT, SL, q, i) (i < RT) and
    the units u0 + 2 up + e (e < 2) whose sums of every gate it takes, as
    arrays (CN, 128, RT) and (CN, 128, 2)."""
    U, R = plan["U"], plan["rows"]
    UP, SL = U // 2, 256 // U
    RT = R // SL
    tid = np.arange(128)
    up, q = tid % UP, tid // UP
    rows = k1_row(RT, SL, q[:, None], np.arange(RT)[None, :])
    rows = np.broadcast_to(rows[None], (cn, len(tid), RT))
    units = (np.arange(cn)[:, None, None] * U + (2 * up)[None, :, None]
             + np.arange(2)[None, None, :])
    return rows, units


def simt_ownership(plan, cn):
    """The kernel's thread -> gate-math map: thread t < 128 runs the cells of
    unit u0 + 2 up of its micro-tile's rows, thread 128 + t those of unit u0
    + 2 up + 1 (their sums from shared memory); each keeps its cells'
    state, stores their out and writes their new h. Arrays (CN, 256, RT)
    of rows and (CN, 256, 1) of units."""
    rows, units = simt_product_tiles(plan, cn)
    rows = np.concatenate([rows, rows], axis=1)
    units = np.concatenate([units[:, :, :1], units[:, :, 1:]], axis=1)
    assert rows.shape[1] == plan["threads"]
    return rows, units


def test_simt_ownership_model_follows_the_kernel_source():
    """The models above are the kernel's: the product thread's unit pair
    and row slot, the gate thread's unit; W_hh staged as [k][up][gate 0,
    1][e] then [k][up][gate 2 (, 3)][e]; for k ascending from 0, h of its
    rows and W of its 2 units of each gate; the second unit's sums through
    `pre`; and the exchange: the cells' new h into the CTA's block, the
    block [u0, u0 + U) x R copied whole to the same place in every other
    CTA."""
    src = _simt_source()
    for line in ("const bool prod = tid < K1_PW;",
                 "const int pt = tid % K1_PW;",
                 "const int up = pt % UP, q = pt / UP;",
                 "const int unit = u0 + 2 * up + (prod ? 0 : 1);",
                 "const int u0 = crank * U;",
                 "const int row0 = (blockIdx.x / cn) * R;",
                 "const int row = row0 + fwd_row(RT, SL, q, i);",
                 "const int pu = i % UP, gate = (i / UP) % NG, k = i / (NG * UP);",
                 "const int o = k * NGU + (gate < 2 ? pu * 4 + gate * 2 : "
                 "WB + pu * (NG - 2) * 2 + (gate - 2) * 2);",
                 "__ldg(reinterpret_cast<const float2*>(W + (size_t)k * G + gate * H + u0 + 2 * pu));",
                 "const float* wp = ws + 4 * up;",
                 "const float* hp = hs + 4 * q;",
                 "const float* wk = wp + k * NGU;",
                 "const float4 w01 = *reinterpret_cast<const float4*>(wk);",
                 "const float4 w23 = *reinterpret_cast<const float4*>(wk + WB);",
                 "const float2 w2 = *reinterpret_cast<const float2*>(wk + WB - 2 * up);",
                 "const float* hk = hp + k * R;",
                 "const float4 v = *reinterpret_cast<const float4*>(hk + j * SL * 4);",
                 "for (int i = NQ * 4; i < RT; ++i) h[i] = hk[fwd_row(RT, SL, q, i) - 4 * q];",
                 "acc[i][gate][0] = fmaf(hr[j][i], wr[j][gate][0], acc[i][gate][0]); "
                 "acc[i][gate][1] = fmaf(hr[j][i], wr[j][gate][1], acc[i][gate][1]);",
                 "pre[(i * NG + gate) * K1_PW + pt] = acc[i][gate][1]; "
                 "sum[i][gate] = acc[i][gate][0];",
                 "for (int gate = 0; gate < NG; ++gate) sum[i][gate] = pre[(i * NG + gate) * K1_PW + pt];",
                 "p.out[((size_t)t * N + row) * 2 * H + d * H + unit] = hnew[i];",
                 "float* hu = hs + (size_t)unit * R;",
                 "*reinterpret_cast<float4*>(hu + (j * SL + q) * 4) =",
                 "for (int i = NQ * 4; i < RT; ++i) hu[fwd_row(RT, SL, q, i)] = hnew[i];",
                 "const uint32_t src = smem_u32(hs + (size_t)u0 * R);",
                 "const uint32_t block_bytes = U * R * 4;",
                 "for (uint32_t r = 1; r < cn; ++r) bulk_to_peer(src, block_bytes, full_bar, "
                 "(crank + r) % cn);"):
        assert line in src, line
    assert ("return i < rt / 4 * 4 ? (i / 4 * nq + q) * 4 + i % 4 : rt / 4 * 4 * nq + "
            "(i - rt / 4 * 4) * nq + q;") in _csrc("rnn_train_rec.cuh")


def product_ring(H, ahead):
    """The product's k loop as the kernel runs it: sets j < AHEAD loaded
    with k = j first; then for k0 = 0, NS, ..., and j < NS, set (j + AHEAD)
    % NS loaded with k0 + j + AHEAD and the FMAs of set j. Returns the k
    each FMA step read and the largest k loaded."""
    ns = ahead + 1
    sets = {}
    for j in range(ahead):
        sets[j] = j
    read, loaded = [], ahead - 1
    for k0 in range(0, H, ns):
        for j in range(ns):
            sets[(j + ahead) % ns] = k0 + j + ahead
            loaded = max(loaded, k0 + j + ahead)
            read.append(sets[j])
    return read, loaded


@pytest.mark.parametrize("cell", ["gru", "lstm"])
@pytest.mark.parametrize("hidden", [16, 32, 64, 128, 256])
def test_simt_product_ring_sums_k_in_order(hidden, cell):
    """The ring of AHEAD + 1 register sets feeds the FMAs k = 0, 1, ..., H -
    1 in order (each (row, unit, gate) one chain over k ascending), and its
    loads past H (at most AHEAD k's) stay inside the CTA's shared memory:
    W's rows run into h, h's into the gate threads' `pre`, which holds more
    than AHEAD rows of h."""
    src = _simt_source()
    assert "constexpr int AHEAD = LSTM ? 1 : 3;" in src
    for line in ("for (int j = 0; j < AHEAD; ++j) load_k(j, wr[j], hr[j]);",
                 "for (int k0 = 0; k0 < H; k0 += NS) {",
                 "load_k(k0 + j + AHEAD, wr[(j + AHEAD) % NS], hr[(j + AHEAD) % NS]);",
                 "static_assert(16 % NS == 0,",
                 "static_assert(RT * NG * K1_PW >= AHEAD * R, \"room past h\");"):
        assert line in src, line
    ahead = 1 if cell == "lstm" else 3
    assert hidden % (ahead + 1) == 0
    read, loaded = product_ring(hidden, ahead)
    assert read == list(range(hidden))
    plan = bigru.k1_plan(hidden, cell, torch.float32)
    assert loaded - hidden + 1 <= ahead
    assert plan["rows_a_thread"] * n_gates(cell) * 128 >= ahead * plan["rows"]


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
    # the product's micro-tiles: every (row, unit) once, with every gate
    rows, units = simt_product_tiles(plan, cn)
    count = np.zeros((R, hidden), dtype=np.int64)
    r_idx = np.broadcast_to(rows[:, :, :, None], rows.shape + (2,))
    u_idx = np.broadcast_to(units[:, :, None, :], r_idx.shape)
    np.add.at(count, (r_idx.ravel(), u_idx.ravel()), 1)
    assert (count == 1).all()
    # the gate math and the h writes: every (row, unit) once
    rows, units = simt_ownership(plan, cn)
    count = np.zeros((R, hidden), dtype=np.int64)
    r_idx = np.broadcast_to(rows[:, :, :, None], rows.shape + (1,))
    u_idx = np.broadcast_to(units[:, :, None, :], r_idx.shape)
    np.add.at(count, (r_idx.ravel(), u_idx.ravel()), 1)
    assert (count == 1).all()
    offsets = u_idx * R + r_idx  # unit u of row r at offset u R + r of the buffer
    for c in range(cn):
        assert units[c].min() == c * U and units[c].max() == (c + 1) * U - 1
        assert sorted(offsets[c].ravel().tolist()) == list(range(c * U * R, (c + 1) * U * R))
    assert sorted(offsets.ravel().tolist()) == list(range(hidden * R))


def staged_w_offset(k, pu, gate, e, U, ng):
    """Where csrc/birnn_simt.cu stages W_hh[k][gate H + u0 + 2 pu + e] of a
    CTA's slice: per k NG U floats, gates 0 and 1 of unit pair pu at 4 pu +
    2 gate + e, gates 2 (and 3) after the 4 (U / 2) floats of those, at 2
    (NG - 2) pu + 2 (gate - 2) + e."""
    wb = 4 * (U // 2)
    return k * ng * U + np.where(gate < 2, pu * 4 + gate * 2 + e,
                                 wb + pu * (ng - 2) * 2 + (gate - 2) * 2 + e)


@pytest.mark.parametrize("cell", ["gru", "lstm"])
@pytest.mark.parametrize("hidden", [16, 32, 64, 128, 256])
def test_simt_w_staging_is_read_back_as_staged(hidden, cell):
    """The staged slice fills [H][NG U] once, and the product's loads (one
    16-byte piece of gates 0 and 1 at 4 up, one 8- or 16-byte piece of the
    rest at WB + 2 (NG - 2) up) read back W_hh[k][gate H + u0 + 2 up + e] for
    every k, gate and unit: the lanes of a warp's 16 (or 8) unit pairs read
    neighbouring pieces."""
    plan = bigru.k1_plan(hidden, cell, torch.float32)
    U, ng = plan["U"], n_gates(cell)
    k, pu, gate, e = np.meshgrid(np.arange(hidden), np.arange(U // 2), np.arange(ng),
                                 np.arange(2), indexing="ij")
    off = staged_w_offset(k, pu, gate, e, U, ng)
    assert sorted(off.ravel().tolist()) == list(range(hidden * ng * U))
    wb = 4 * (U // 2)
    read = np.where(gate < 2, k * ng * U + 4 * pu + 2 * gate + e,
                    k * ng * U + wb + 2 * (ng - 2) * pu + 2 * (gate - 2) + e)
    assert (read == off).all()
    piece = 4 if ng == 4 else 2  # floats of the second load a thread
    assert (np.diff(read[0, :, 2, 0]) == piece).all()
    assert (np.diff(read[0, :, 0, 0]) == 4).all()


def test_simt_waves_at_the_main_path_rows():
    """At H = 256 each CTA holds more than half the SM's shared memory (one
    CTA an SM), 72 rows a tile in clusters of 8: at 1,024 rows 15 tiles a
    direction, 30 clusters, two full waves of the 15 clusters of 8 that the
    H100 holds at once (cudaOccupancyMaxActiveClusters, chip_smoke.py's
    K1 fp32 cell); at 16,384 rows 31 waves, the last 40% full."""
    for cell in ("gru", "lstm"):
        plan = bigru.k1_plan(256, cell, torch.float32)
        assert plan["smem"] > SMEM_LIMIT // 2 and plan["CN"] == 8
        clusters = {rows: 2 * -(-rows // plan["rows"]) for rows in (1024, 16384)}
        assert clusters == {1024: 30, 16384: 456}
        assert {rows: -(-n // 15) for rows, n in clusters.items()} == {1024: 2, 16384: 31}


def simt_tile_walk(rows, plan):
    """The grid of a call as birnn_simt_rec_launch makes it, (CN tiles, 2)
    CTAs in clusters of CN along x: CTA (bx, d) is rank bx % CN of the
    cluster of tile bx / CN, direction d. Returns {(d, tile): [rank, ...]}
    and the count of the (row, direction, unit) micro-tile entries over the
    call's (N, 2, H), each with every gate."""
    cn, R, H = plan["CN"], plan["rows"], plan["CN"] * plan["U"]
    tiles = -(-rows // R)
    prows, punits = simt_product_tiles(plan, cn)  # (CN, 128, RT), (CN, 128, 2)
    count = np.zeros((rows, 2, H), np.int64)
    clusters = {}
    for d in range(2):
        for bx in range(cn * tiles):
            tile, rank = bx // cn, bx % cn
            clusters.setdefault((d, tile), []).append(rank)
            r = tile * R + prows[rank][:, :, None]  # (128, RT, 1)
            u = np.broadcast_to(punits[rank][:, None, :], (prows.shape[1], prows.shape[2], 2))
            r = np.broadcast_to(r, u.shape)
            live = r < rows
            np.add.at(count, (r[live], d, u[live]), 1)
    return clusters, count


@pytest.mark.parametrize("rows", [504, 505, 1000, 1024, 1031, 6143])
def test_simt_tile_walk_covers_every_row_and_direction_in_the_claimed_waves(rows):
    """At H = 256 and each row count below the rows crossover, the grid's
    clusters of 8 cover every (row, direction, unit) of the call once (each
    with every gate: a product thread's micro-tile holds them all), past no
    row N; the clusters number 2 ceil(N / 72): one wave of the 15 the card
    holds up to 504 rows, two at the default batch's 1,024 (30 clusters),
    ceil(clusters / 15) beyond."""
    plan = bigru.k1_plan(256, "gru", torch.float32, rows)
    assert (plan["design"], plan["rows"], plan["CN"]) == ("simt", 72, 8)
    clusters, count = simt_tile_walk(rows, plan)
    assert (count == 1).all()
    assert all(sorted(ranks) == list(range(8)) for ranks in clusters.values())
    n = len(clusters)
    assert n == 2 * -(-rows // 72)
    waves = -(-n // 15)
    assert (waves == 1) == (rows <= 504)
    if rows == 1024:
        assert (n, waves) == (30, 2)


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
    ne = units.shape[-1]
    r_idx = np.broadcast_to(rows[:, :, :, None], rows.shape + (ne,)).ravel()
    u_idx = np.broadcast_to(units[:, :, None, :], rows.shape + (ne,)).ravel()
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
@pytest.mark.parametrize("hidden,rows", [(16, 13), (32, 70), (64, 5), (256, 21)])
def test_simt_model_is_bit_equal_to_the_plain_version(hidden, rows, cell):
    """In fp32 on the CPU the model of the kernel's ownership and exchange,
    over ragged row tiles and clusters of 1, 2 and 8 CTAs (H = 256: the
    72-row tiles), gives the plain version's out and h_n bit for bit."""
    rng = np.random.RandomState(hidden + rows)
    layers = [layer_weights(ld) for ld in init_rnn_params(rng, 11, hidden, 2, cell)]
    x = torch.from_numpy(rng.randn(7, rows, 11).astype(np.float32))
    plan = bigru.k1_plan(hidden, cell, torch.float32)
    out, hn = simt_model(layers, x, cell, plan)
    ref_out, ref_hn = bigru.birnn_stack_plain(layers, x, torch.float32, cell)
    assert torch.equal(out, ref_out) and torch.equal(hn, ref_hn)


class _Bar:
    """An mbarrier: ``count`` arrivals a phase, the pending arrivals and
    tx-count of the current phase, and the phases completed (``done``)."""

    def __init__(self, count):
        self.count, self.pending, self.tx, self.done = count, count, 0, 0

    def arrive(self, tx=0):
        self.tx += tx
        self.pending -= 1
        self._complete()

    def complete_tx(self, n):
        self.tx -= n
        self._complete()

    def _complete(self):
        if self.pending == 0 and self.tx == 0:
            self.done += 1
            self.pending = self.count

    def passed(self, phase):
        """Whether a wait on the parity of ``phase`` returns; a parity wait
        is exact only while the barrier is at that phase or one past it."""
        assert phase <= self.done <= phase + 1, ("a phase ahead or behind", phase, self.done)
        return self.done == phase + 1


def k1_rec_protocol(CN, L, seed):
    """birnn_rec_kernel's exchange on one cluster under a random
    interleaving. Each CTA is two agents, its thread 0 and the rest,
    meeting at its __syncthreads; a step: both wait on `full` (step > 0);
    the product reads every block of the CTA's h buffer, each of which must
    hold h(s); then, unless it is the last step, thread 0 waits until its
    copies have read their source and arms `full` with the bytes to come, a
    __syncthreads, and threads t < CN (not the CTA's rank; t = 0 is thread
    0's) arrive on peer t's `empty`; both agents write their part of the own
    block (h(s + 1)); a __syncthreads; thread 0 waits on `empty` and issues
    the copies to the peers as one group. A copy reads its source some time
    later (which must still hold the step it was issued for) and lands some
    time after that (the receiver must have read the step before: the
    one-buffer hazard), completing its bytes on the receiver's `full`. Every
    wait checks that its barrier is at the phase waited for or one past.
    Returns each CTA's state and the order of the products, or fails on a
    hazard or a deadlock."""
    rng = np.random.RandomState(seed)
    ctas = [{"blocks": [0] * CN, "own": [0, 0], "full": _Bar(1), "empty": _Bar(max(CN - 1, 1)),
             "read": [-1, -1], "groups": [], "sync": [0, 0]} for _ in range(CN)]
    copies, products = [], []

    def sync(c, who):  # the CTA's __syncthreads: a generation both agents reach
        cta = ctas[c]
        cta["sync"][who] += 1
        return ("sync", c, cta["sync"][who])

    def agent(c, who):
        cta = ctas[c]
        for s in range(L):
            more = s + 1 < L
            if CN > 1 and s > 0:
                yield ("wait", cta["full"], s - 1)
            assert all(tag == s for i, tag in enumerate(cta["blocks"]) if i != c), (c, s)
            assert cta["own"] == [s, s], (c, s, cta["own"])
            cta["read"][who] = s
            if who == 0:
                products.append((c, s))
            if more:
                if who == 0 and CN > 1:
                    yield ("wait_read", cta)
                    cta["full"].arrive(tx=CN - 1)
                yield sync(c, who)
                if CN > 1:
                    for t in ([0] if who == 0 else range(1, CN)):
                        if t != c:
                            ctas[t]["empty"].arrive()
            if not more:
                break
            cta["own"][who] = s + 1
            yield sync(c, who)
            if CN > 1 and who == 0:
                yield ("wait", cta["empty"], s)
                group = [{"src": c, "dst": (c + r) % CN, "tag": s + 1, "state": "issued"}
                         for r in range(1, CN)]
                cta["groups"].append(group)
                copies.extend(group)
        if who == 0 and CN > 1:
            yield ("wait_read", cta)

    agents = {(c, w): agent(c, w) for c in range(CN) for w in (0, 1)}
    at = {k: next(a, None) for k, a in agents.items()}

    def runnable(k):
        op = at[k]
        if op is None:
            return False
        if op[0] == "wait":
            return op[1].passed(op[2])
        if op[0] == "sync":
            return min(ctas[op[1]]["sync"]) >= op[2]
        return all(cp["state"] != "issued" for grp in op[1]["groups"] for cp in grp)

    while True:
        moves = [("agent", k) for k in agents if runnable(k)]
        moves += [("copy", cp) for cp in copies if cp["state"] != "landed"]
        if not moves:
            break
        kind, obj = moves[rng.randint(len(moves))]
        if kind == "agent":
            at[obj] = next(agents[obj], None)
        elif obj["state"] == "issued":  # the copy reads its source block
            assert ctas[obj["src"]]["own"] == [obj["tag"]] * 2, obj
            obj["state"] = "read"
        else:  # and lands in the receiver's buffer
            dst = ctas[obj["dst"]]
            assert min(dst["read"]) >= obj["tag"] - 1, ("landed on unread h", obj)
            dst["blocks"][obj["src"]] = obj["tag"]
            dst["full"].complete_tx(1)
            obj["state"] = "landed"
    assert all(op is None for op in at.values()), "deadlock"
    return ctas, products


@pytest.mark.parametrize("seed", range(8))
@pytest.mark.parametrize("cn,steps", [(1, 3), (2, 1), (2, 2), (2, 5), (4, 3), (8, 2), (8, 4)])
def test_simt_exchange_protocol(cn, steps, seed):
    """The f32 recurrence's `full` / `empty` protocol on one cluster under
    random interleavings (``k1_rec_protocol``): no deadlock, no block read
    before it holds the step's h, no copy that reads a block overwritten or
    lands on h not yet read, no barrier a phase ahead of its waiter; each
    CTA's products run in step order, and at the end each `full` and
    `empty` has completed one phase a step but the last."""
    ctas, products = k1_rec_protocol(cn, steps, seed)
    for c, cta in enumerate(ctas):
        if cn > 1:
            assert cta["full"].done == cta["empty"].done == steps - 1
        assert cta["read"] == [steps - 1, steps - 1]
        assert [s for cc, s in products if cc == c] == list(range(steps))


def test_simt_exchange_protocol_follows_the_kernel_source():
    """The model's order of the exchange is the kernel's: `full` waited
    for phase s - 1, armed after the copies have read, `empty` arrivals
    after the barrier that ends the product, the copies after the wait on
    `empty` phase s."""
    src = _simt_source()
    order = ["if (cn > 1 && s > 0) mbar_wait(full_bar, (s - 1) & 1);",
             "asm volatile(\"cp.async.bulk.wait_group.read 0;\\n\" ::: \"memory\"); "
             "mbar_expect_tx(full_bar, (cn - 1) * block_bytes);",
             "__syncthreads(); // every thread has read h(s)",
             "if (!last && cn > 1 && tid < (int)cn && tid != (int)crank) "
             "mbar_arrive_remote(empty_bar, tid);",
             "__syncthreads(); // the block is whole",
             "mbar_wait(empty_bar, s & 1);",
             "bulk_to_peer(src, block_bytes, full_bar, (crank + r) % cn);"]
    at = [src.index(line) for line in order]
    assert at == sorted(at)
    assert "mbar_init(empty_bar, cn > 1 ? cn - 1 : 1);" in src and "mbar_init(full_bar, 1);" in src


def fmaf32(a, b, c):
    """fmaf on float32 arrays: a b + c rounded once to float32. The product
    of two float32 values is exact in float64; TwoSum gives the float64 sum
    s and its exact error e; s rounds to float32 as the exact sum does
    except where s is a float32 midpoint, where the sign of e decides."""
    a, b, c = (np.asarray(v, np.float32).astype(np.float64) for v in (a, b, c))
    p = a * b
    s = p + c
    bb = s - p
    e = (p - (s - bb)) + (c - bb)
    r = s.astype(np.float32)
    rd = r.astype(np.float64)
    lo = np.where(s > rd, r, np.nextafter(r, np.float32(-np.inf)))
    hi = np.where(s > rd, np.nextafter(r, np.float32(np.inf)), r)
    tie = s == (lo.astype(np.float64) + hi.astype(np.float64)) / 2
    return np.where(tie & (e > 0), hi, np.where(tie & (e < 0), lo, r)).astype(np.float32)


def proj_chain(x, w, b0, b1, nfold, bk):
    """One direction of the f32 projection as a kernel computes it: each
    element one fmaf chain over k ascending from 0.0f in k tiles of bk (the
    zeros past C included), then + (b_ih + the folded b_hh)."""
    M, K = x.shape
    G = w.shape[1]
    acc = np.zeros((M, G), np.float32)
    for k in range(-(-K // bk) * bk):
        a = x[:, k] if k < K else np.zeros(M, np.float32)
        b = w[k] if k < K else np.zeros(G, np.float32)
        acc = fmaf32(a[:, None], b[None, :], acc)
    n = np.arange(G)
    bias = (b0 + np.where(n < nfold, b1, np.float32(0.0))).astype(np.float32)
    return (acc + bias).astype(np.float32)


def f32_proj_owners(M, G, rm=8):
    """f32_tma_kernel's projection tile -> element map: CTA (bx, by) of each
    direction d, thread (tx, ty) = (t % 8, t / 8) of 128, accumulator (i, j)
    holds xg[d][m][n], m = 16 rm by + ty + 16 i (i < rm; X K-major: one
    swizzle a thread), n = 128 bx + 32 (j / 4) + 4 tx + j % 4. Returns the
    count of owners of each element of (2, M, G) within the matrix."""
    count = np.zeros((2, M, G), np.int64)
    t = np.arange(128)
    tx, ty = t % 8, t // 8
    i, j = np.arange(rm), np.arange(16)
    rows = ty[:, None] + 16 * i                                              # (128, rm)
    cols = 32 * (j // 4) + 4 * tx[:, None] + j % 4                           # (128, 16)
    for d in range(2):
        for by in range(-(-M // (16 * rm))):
            for bx in range(-(-G // 128)):
                m = np.broadcast_to((16 * rm * by + rows)[:, :, None], (128, rm, 16))
                n = np.broadcast_to((128 * bx + cols)[:, None, :], (128, rm, 16))
                ok = (m < M) & (n < G)
                np.add.at(count[d], (m[ok], n[ok]), 1)
    return count


@pytest.mark.parametrize("rm", [7, 8])
@pytest.mark.parametrize("M,G", [(1, 48), (13, 64), (200, 96), (1029, 768), (300, 1024)])
def test_f32_projection_owns_every_element_once(M, G, rm):
    """Every element of xg (2, M, G) has exactly one owning thread (one
    accumulator of one CTA), at ragged rows and widths below a tile, in
    tiles of 128 and of 112 rows."""
    assert (f32_proj_owners(M, G, rm) == 1).all()


def test_f32_projection_model_follows_the_kernel_source():
    """The ownership and the order of the sums above are the kernel's: the
    thread's rows and columns, the CTA's k tiles ascending (q), 4-k chunks
    ascending (c) and k within a chunk ascending (kk), each fmaf onto the
    one accumulator from 0.0f, and the bias added once after the chain as
    gemm_simt_kernel adds it."""
    src = _csrc("rnn_train_gemm.cuh")
    for line in ("#define FT_THREADS 128", "#define FT_BM 128",
                 "static constexpr int BM = 16 * RM, BN = 8 * TN;",
                 "const int tid = threadIdx.x, lane = tid & 31, tx = tid % 8, ty = tid / 8;",
                 "const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;",
                 "if (AK) return ty + 16 * i;",
                 "const float* ar = as + ty * KT;",
                 "const float4 v = *reinterpret_cast<const float4*>(ar + 16 * KT * i + ((c ^ asw) << 2));",
                 "const float4 v = *reinterpret_cast<const float4*>(bs + k * BN + q * 32 + tx * 4);",
                 "for (int q = 0; q < NT; ++q) {",
                 "for (int c = 0; c < nc; ++c) {",
                 "for (int kk = 0; kk < 4; ++kk) { if (kk < 3) load_b(4 * c + kk + 1, bb[(kk + 1) & 1]);",
                 "for (int j = 0; j < 16; ++j) acc[i][j] = fmaf(a[i][kk], bb[kk & 1][j], acc[i][j]);",
                 "acc[i][j] = 0.0f;",
                 "return jb.bias0[n] + (n < jb.nfold ? jb.bias1[n] : 0.0f);",
                 "for (int e = 0; e < 4; ++e) bias[e] = n + e < N ? bias_of(n + e) : 0.0f;",
                 "const int m = m0 + ft_row<AK>(ty, i);",
                 "const int n = n0 + q * 32 + tx * 4;",
                 "make_float4(v[0] + bias[0], v[1] + bias[1], v[2] + bias[2], v[3] + bias[3]);",
                 # the simt kernel's bias, which the new one keeps
                 "return jb.bias0[n] + (n < jb.nfold ? jb.bias1[n] : 0.0f);",
                 # both directions one launch, 112 or 128 rows by the waves,
                 # b_hh's first nfold columns folded
                 "const int RM = ft_rows(M, 2LL * ((G + FT_BM - 1) / FT_BM));",
                 "return RM == 7 ? proj_launch<7>(maps, p, grid, s, x_tma, C % FT_KT != 0) "
                 ": proj_launch<8>(maps, p, grid, s, x_tma, C % FT_KT != 0);",
                 "if (!x_tma) return ft_launch<true, false, RM, 16, true, true>(maps, p, grid, s);",
                 "return part ? ft_launch<true, false, RM, 16, false, true>(maps, p, grid, s) "
                 ": ft_launch<true, false, RM, 16, false, false>(maps, p, grid, s);",
                 "p.job[d] = FtJob{{0, 0, 0, 0, 0}, {0, 0, 0, d, d}, M, G, !x_tma, "
                 "xg + (size_t)d * M * G, G, bih + d * G, bhh + d * G, nfold, nullptr};",

                 # every f32 projection runs it
                 "if constexpr (std::is_same<T, float>::value) return proj_f32_run("):
        assert line in src, line


def ft_kt():
    """FT_KT, the k of a ring slot of f32_tma_kernel, as the source sets it."""
    return int(re.search(r"#define FT_KT (\d+)", _csrc("rnn_train_gemm.cuh")).group(1))


@pytest.mark.parametrize("cin", [11, 21, 28, 52, 64])
def test_f32_projection_chain_equals_the_simt_gemm_chain(cin):
    """The new projection's sums (k tiles of FT_KT, zeros past C) and
    gemm_simt_kernel's (k tiles of 8) are the same fmaf chain over k
    ascending from 0.0f, so xg keeps every bit at the models' widths (C =
    11, 21, 28, 52) and a width of whole tiles; both within a few float32
    ulps of the exact sums."""
    rng = np.random.RandomState(cin)
    M, G = 37, 96
    x = rng.randn(M, cin).astype(np.float32)
    w = (0.3 * rng.randn(cin, G)).astype(np.float32)
    b0, b1 = rng.randn(2, G).astype(np.float32)
    new = proj_chain(x, w, b0, b1, 64, ft_kt())
    old = proj_chain(x, w, b0, b1, 64, 8)
    assert np.array_equal(new.view(np.uint32), old.view(np.uint32))
    exact = (x.astype(np.float64) @ w.astype(np.float64) + b0
             + np.where(np.arange(G) < 64, b1, 0.0))
    scale = np.abs(x).astype(np.float64) @ np.abs(w).astype(np.float64) + 2
    assert (np.abs(new - exact) <= 4 * np.finfo(np.float32).eps * scale).all()


def test_fmaf32_rounds_once():
    """The model's fmaf rounds a b + c once: against exact rational sums on
    random values and on ties that a double rounding would break."""
    from fractions import Fraction

    rng = np.random.RandomState(3)
    a, b, c = (rng.randn(3, 300) * 10.0 ** rng.randint(-3, 4, (3, 300))).astype(np.float32)
    got = fmaf32(a, b, c)
    for ai, bi, ci, gi in zip(a, b, c, got):
        exact = Fraction(float(ai)) * Fraction(float(bi)) + Fraction(float(ci))
        lo = np.float32(float(exact))
        cands = [np.nextafter(lo, np.float32(-np.inf)), lo, np.nextafter(lo, np.float32(np.inf))]
        best = min(cands, key=lambda v: (abs(Fraction(float(v)) - exact),
                                         int(np.asarray(v).view(np.uint32)) & 1))
        assert gi == best, (ai, bi, ci, gi, best)
    # a b = +-(2^-24 - 2^-54): the float64 sum lands on a float32 midpoint
    # that the exact sum misses by 2^-54, below (rounds to the odd neighbour
    # below, where ties-to-even would go up) and above (to the odd one above)
    a = np.float32((1 + 2.0 ** -15) * 2.0 ** -12)
    b = np.float32((1 - 2.0 ** -15) * 2.0 ** -12)
    assert fmaf32(a, b, np.float32(1 + 2.0 ** -23)) == np.float32(1 + 2.0 ** -23)
    assert fmaf32(-a, b, np.float32(1 + 2.0 ** -22 + 2.0 ** -23)) == \
        np.float32(1 + 2.0 ** -22 + 2.0 ** -23)


@pytest.mark.parametrize("cell", ["gru", "lstm"])
def test_f32_projection_model_matches_the_plain_version(cell):
    """K1's fp32 stack with each layer's xg from the projection model (one
    owner each, its chain, b_hh folded where the kernel folds it) and the
    plain recurrence on it agrees with ``birnn_stack_plain`` within the
    card's fp32 tolerance (1e-5): the fold changes only the order of the
    bias additions."""
    rng = np.random.RandomState(11)
    H, N, L = 16, 5, 4
    layers = [layer_weights(ld) for ld in init_rnn_params(rng, 11, H, 2, cell)]
    x = torch.from_numpy(rng.randn(L, N, 11).astype(np.float32))
    ng = n_gates(cell)
    nfold = 2 * H if cell == "gru" else ng * H
    inp, h_ns = x, []
    for wih, bih, whh, bhh in layers:
        flat = inp.reshape(L * N, -1).numpy()
        outs = []
        for d in (0, 1):
            xg = torch.from_numpy(proj_chain(flat, wih[d].numpy(), bih[d].numpy(),
                                             bhh[d].numpy(), nfold, ft_kt())).view(L, N, -1)
            # the recurrence adds only what the projection did not fold
            b_rest = bhh[d].clone()
            b_rest[:nfold] = 0.0
            h = torch.zeros((N, H))
            c = torch.zeros((N, H))
            ys = [None] * L
            for s in range(L):
                t = s if d == 0 else L - 1 - s
                hg = h @ whh[d] + b_rest
                if cell == "gru":
                    h = gru_cell(xg[t], hg, h)[0]
                else:
                    h, c = lstm_cell(xg[t] + hg, c)[:2]
                ys[t] = h
            h_ns.append(h)
            outs.append(torch.stack(ys))
        inp = torch.cat(outs, dim=-1)
    ref_out, ref_hn = bigru.birnn_stack_plain(layers, x, torch.float32, cell)
    assert (inp - ref_out).abs().max().item() <= 1e-5
    assert (torch.stack(h_ns) - ref_hn).abs().max().item() <= 1e-5


@pytest.mark.parametrize("seq_len,d,ff,nhead", [(21, 256, 512, 4), (21, 128, 256, 2),
                                               (32, 256, 512, 4), (1, 128, 128, 2)])
def test_k3_plan_takes_the_model_shapes(seq_len, d, ff, nhead):
    plan = transenc.k3_plan(seq_len, d, ff, nhead)
    assert plan["design"] == "tc", plan
    assert plan["S"] == transenc.TC_ROWS // seq_len and plan["S"] * seq_len <= 64
    assert plan["smem"] <= SMEM_LIMIT


@pytest.mark.parametrize("seq_len,d,ff,nhead,dtype,why", [
    (21, 256, 512, 4, torch.float32, "fp32"),
    (33, 256, 512, 4, torch.bfloat16, "L >"),
    (21, 48, 128, 4, torch.bfloat16, "not 128 or 256"),
    (21, 256, 512, 8, torch.bfloat16, "head width"),
    (21, 128, 256, 4, torch.bfloat16, "head width"),
    (21, 256, 1536, 4, torch.bfloat16, "shared memory"),
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
            dict(bigru.tc_projection_calls), transenc.launches, transenc.cuda_launches, dict(transenc.design_calls))


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
            dict(bigru.tc_projection_calls),
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


def test_simt_probe_marks_apply_once():
    """chip_smoke.py's k1_simt_probe builds a copy of csrc/birnn_simt.cu
    with clock64 marks put in by text replacement: each anchor of
    ``K1_SIMT_PROBE_MARKS`` is in the shipped source exactly once (and in
    the source as marked so far), and every part of a step is marked."""
    import importlib.util

    path = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                        "chip_smoke.py")
    spec = importlib.util.spec_from_file_location("chip_smoke_k1_marks", path)
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    with open(os.path.join(os.path.dirname(bigru.__file__), "csrc", bigru.SIMT_SRC)) as f:
        src = f.read()
    for old, new in smoke.K1_SIMT_PROBE_MARKS:
        assert src.count(old) == 1, old
        src = src.replace(old, new)
    marked = "".join(new for _old, new in smoke.K1_SIMT_PROBE_MARKS)
    assert all("pr_t[{}]".format(k) in marked for k in range(len(smoke.K1_SIMT_PROBE_PARTS)))

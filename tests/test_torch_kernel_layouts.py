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
    """The rule reads H, the cell and the dtype; any row count takes the
    design it picks (the recurrence grid covers ceil(N / rows) row tiles).
    The geometry is TC_GEOMETRY's at H = 256 and TC_BY_U's below, with the
    kernel's shared-memory formula, within the 227 KB."""
    plan = bigru.k1_plan(hidden, cell)
    assert plan["design"] == "tc", plan
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

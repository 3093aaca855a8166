"""K4 and K5's shape rule and K5's staged layout, on the CPU (no card): the
planner ``k45_plan`` that picks each call's design; a model of the K5
recurrence's W_hh staging and reduce-scatter (csrc/rnn_train_rec.cuh, the
recurrences of csrc/bigru_train.cu, stages W_hh in shared memory itself):
for the simt design its thread maps, operand image, partials' buffer slots
and rank-order sums, held to the kernel source and, through a plain
backward in that layout, to ``bigru_layer_bwd_plain`` and the JAX
package's ``fused_bigru_layer_tm`` (interpret mode); and the launch
counters, which a CPU call leaves alone."""

import os

import numpy as np
import pytest
import torch

from ccsmeth_tpu_torch.models.rnn import init_rnn_params, layer_weights
from ccsmeth_tpu_torch.ops import bigru_vjp
from ccsmeth_tpu_torch.ops.kernel_args import SMEM_LIMIT

torch.set_num_threads(1)  # one intra-op thread: the suite runs several workers at once


@pytest.mark.parametrize("hidden", [16, 32, 64, 256])
def test_k45_plan_takes_fp32_on_simt(hidden):
    plan = bigru_vjp.k45_plan(hidden, torch.float32)
    assert plan["design"] == "simt" and "fp32" in plan["why"]
    U, cn = plan["U"], plan["CN"]
    assert U == min(hidden, 32) and U * cn == hidden and cn in (1, 2, 4, 8)
    # a K4 thread owns one unit's 3 gates of RT rows (256 threads: NGR warp
    # groups of U units by NQ row slots); a K5 thread the partial of RT rows x 8 units (256
    # threads: NR row groups x H / 8 unit groups) and the gate math of at
    # most QM quads of 4 units of a row half
    f = bigru_vjp.simt_fwd_geometry(hidden)
    assert plan["rows_fwd"] == f["R"] == f["NGR"] * f["NQ"] * f["RT"]
    assert f["NGR"] * f["NQ"] * U == 256
    g = bigru_vjp.simt_bwd_geometry(hidden)
    assert plan["rows_bwd"] == g["R"] == g["NR"] * g["RT"]
    assert g["NR"] * (hidden // 8) == 256 and g["QM"] * 256 * 4 >= g["R0"] * U
    assert max(plan["smem_fwd"], plan["smem_bwd"]) <= SMEM_LIMIT


@pytest.mark.parametrize("hidden,U,cn", [(32, 32, 1), (64, 64, 1), (128, 64, 2),
                                         (256, 64, 4)])
def test_k45_plan_takes_bf16_on_tc(hidden, U, cn):
    plan = bigru_vjp.k45_plan(hidden, torch.bfloat16)
    assert (plan["design"], plan["U"], plan["CN"]) == ("tc", U, cn)
    assert (plan["rows_fwd"], plan["rows_bwd"]) == (64, 32)
    assert plan["smem_fwd"] == (3 * U + 128) * (hidden + 8) * 2
    assert plan["smem_bwd"] == bigru_vjp.k5_smem("tc", hidden, U, 32)
    assert max(plan["smem_fwd"], plan["smem_bwd"]) <= SMEM_LIMIT


def test_k45_plan_at_the_model_width():
    """H = 256, the header's arithmetic: tc CTAs of 168,960 (K4) and 188,928
    (K5) bytes in clusters of 4; simt of 98,304 + 73,728 + 32 = 172,064 (the
    W_hh slice [k][gate][u], h of the 72 rows, four barriers) and 98,304 +
    73,728 + 16,000 + 32 = 188,064 (the W_hh slice, the 8 x 72 x 32 f32
    partials received, the 40 x 100 operand of a row half, four barriers)
    in clusters of 8."""
    tc = bigru_vjp.k45_plan(256, torch.bfloat16)
    simt = bigru_vjp.k45_plan(256, torch.float32)
    assert (tc["CN"], tc["smem_fwd"], tc["smem_bwd"]) == (4, 168960, 188928)
    assert (simt["CN"], simt["smem_fwd"], simt["smem_bwd"]) == (8, 172064, 188064)
    assert simt["smem_fwd"] == 256 * 3 * 32 * 4 + 256 * 72 * 4 + 32
    assert simt["smem_bwd"] == 96 * 256 * 4 + 8 * 72 * 32 * 4 + 40 * 100 * 4 + 32
    assert (simt["rows_fwd"], simt["rows_bwd"]) == (72, 72)


def test_k45_plan_sends_bf16_h16_to_simt():
    plan = bigru_vjp.k45_plan(16, torch.bfloat16)
    assert plan["design"] == "simt" and plan["why"] == "tc: H % 32 != 0"
    assert (plan["U"], plan["CN"], plan["rows_fwd"], plan["rows_bwd"]) == (16, 1, 128, 128)


@pytest.mark.parametrize("hidden,dtype,reasons", [
    (20, torch.float32, ["simt: H must be 16 or a multiple of 32", "fp32"]),
    (48, torch.bfloat16, ["simt: H must be 16 or a multiple of 32", "tc: H % 32"]),
    (96, torch.bfloat16, ["simt: a cluster of 3 CTAs", "tc: a cluster of 3 CTAs"]),
    (512, torch.bfloat16, ["simt: a cluster of 16 CTAs", "tc: 356864 bytes"]),
    (512, torch.float32, ["simt: a cluster of 16 CTAs", "fp32"]),
])
def test_k45_plan_names_why_it_refuses(hidden, dtype, reasons):
    with pytest.raises(ValueError) as err:
        bigru_vjp.k45_plan(hidden, dtype)
    msg = str(err.value)
    assert msg.startswith("K4/K5 take no design for H={}".format(hidden))
    for r in reasons:
        assert r in msg, (r, msg)


def own_columns(H, U, c, ng=3):
    """The W_hh columns of CTA c in K5's recurrence (ng = 4: K6's), in staged
    order: k = gate*U + u holds column gate*H + c*U + u."""
    gate = torch.arange(ng).view(-1, 1)
    u = torch.arange(U).view(1, -1)
    return (gate * H + c * U + u).reshape(-1)


def stage_k5(whh, U, design):
    """One direction's W_hh (H, 3H) -> the shared-memory image of each CTA of
    a K5 cluster: simt [3U][H] (row k, unit j contiguous), tc [H][3U] (unit
    j, k contiguous; the kernel pads each row by 8)."""
    H = whh.shape[0]
    slices = [whh[:, own_columns(H, U, c)] for c in range(H // U)]
    return torch.stack([s.T if design == "simt" else s for s in slices])


def unstage_k5(staged, U, design):
    """The inverse of ``stage_k5``."""
    cn = staged.shape[0]
    H = cn * U
    w = staged.new_empty((H, 3 * H))
    for c in range(cn):
        w[:, own_columns(H, U, c)] = staged[c].T if design == "simt" else staged[c]
    return w


@pytest.mark.parametrize("hidden,design", [(16, "simt"), (64, "simt"), (256, "simt"),
                                           (32, "tc"), (64, "tc"), (256, "tc")])
def test_k5_staging_round_trip(hidden, design):
    U = min(hidden, 32) if design == "simt" else (64 if hidden % 64 == 0 else 32)
    whh = torch.from_numpy(np.random.RandomState(hidden).randn(hidden, 3 * hidden)
                           .astype(np.float32))
    staged = stage_k5(whh, U, design)
    cn = hidden // U
    assert staged.shape == ((cn, 3 * U, hidden) if design == "simt" else (cn, hidden, 3 * U))
    for c, gate, u, j in ((0, 0, 0, 0), (cn - 1, 2, U - 1, hidden - 1), (cn // 2, 1, 3, 5)):
        k = gate * U + u
        v = staged[c, k, j] if design == "simt" else staged[c, j, k]
        assert v == whh[j, gate * hidden + c * U + u]
    assert torch.equal(unstage_k5(staged, U, design), whh)


def simt_bwd_maps(H):
    """The simt backward recurrence's thread maps at H, as
    csrc/rnn_train_rec.cuh::bwd_rec_simt_kernel computes them from tid: the
    gate math's quads of each row half (quad g = tid + 256 j of the half,
    while g < its rows x U / 4: local row g / (U / 4), units 4 (g % (U / 4))
    .. +3; ``quads[h]`` holds (tid, local row, first unit) of each) and the
    product's tile (rows rg + i NR, units 4 jg .. +3 and H / 2 + 4 jg .. +3,
    with jg and rg from the warp's and the lane's place)."""
    g = bigru_vjp.simt_bwd_geometry(H)
    U, R, R0, NR, RT, JL, NJW = (g[k] for k in ("U", "R", "R0", "NR", "RT", "JL", "NJW"))
    uq = U // 4
    tid = np.arange(256)
    warp, lane = tid // 32, tid % 32
    jg = (warp % NJW) * JL + lane % JL
    rg = (warp // NJW) * (32 // JL) + lane // JL
    quads = []
    for h in range(g["NH"]):
        rh = R0 if h == 0 else R - R0
        q = np.arange(-(-rh * uq // 256) * 256)
        q = q[q < rh * uq]
        quads.append(np.stack([q % 256, q // uq, 4 * (q % uq)], axis=1))
    return dict(g, quads=quads,
                tile_rows=rg[:, None] + np.arange(RT)[None, :] * NR,
                tile_units=np.concatenate([4 * jg[:, None] + np.arange(4),
                                           H // 2 + 4 * jg[:, None] + np.arange(4)], axis=1))


def simt_bwd_partials(op_tile, staged, H):
    """One step of the simt backward's exchange on one row tile, moving the
    data as the kernel does, one row half after the other. op_tile (R, NG
    H): op(dg) of the tile's rows, column gate H + unit; staged (CN, NG U,
    H): each CTA's W_hh slice [k][j]. For half h (rows [h R0, h R0 + rh)),
    CTA c's gate-math threads write the operand image [R0][NG U + 4] (local
    row, own column k = gate U + u); each product thread reads its rows of
    the half from it and its 8 columns of the slice into a partial, and
    stores each 4-unit half of it into the CTA that owns those units, slot
    [c][local row][u] of the half's buffer. Returns, for each half, the
    owners' buffers (owner, slot c, rh, U; NaN where nothing was stored) and
    the operand images (CN, R0, NG U + 4)."""
    m = simt_bwd_maps(H)
    U, CN, R, R0, RT0 = m["U"], m["CN"], m["R"], m["R0"], m["RT0"]
    ug = staged.shape[1]
    tunits = torch.as_tensor(m["tile_units"])
    halves = []
    for h in range(m["NH"]):
        lo, rh = h * R0, R0 if h == 0 else R - R0
        rows = torch.as_tensor(m["quads"][h][:, 1])[:, None]  # the half's local rows
        units = torch.as_tensor(m["quads"][h][:, 2])[:, None] + torch.arange(4)
        i = slice(0, RT0) if h == 0 else slice(RT0, None)
        trows = torch.as_tensor(m["tile_rows"][:, i]) - lo
        imgs = torch.zeros((CN, R0, ug + 4))
        bufs = torch.full((CN, CN, rh, U), float("nan"))
        for c in range(CN):
            for k in range(ug // U):  # the gate math: quad (row, u .. u + 3) -> k U + u ..
                imgs[c][rows, k * U + units] = op_tile[rows + lo, k * H + c * U + units]
            part = torch.einsum("trk,ktj->trj", imgs[c][trows][:, :, :ug],
                                staged[c][:, tunits])
            for e2 in range(2):
                own, ju = tunits[:, 4 * e2] // U, tunits[:, 4 * e2] % U
                for e in range(4):
                    bufs[own[:, None], c, trows, (ju + e)[:, None]] = part[:, :, 4 * e2 + e]
        halves.append((bufs, imgs))
    return halves


def simt_bwd_dh(bufs, carry):
    """The owners' sums of one step for one row half: dh[r, b U + u] = carry
    + the partials of slots 0 .. CN-1 of owner b's buffer, added in rank
    order (carry: the GRU's dt z; zeros for the LSTM, whose kernel starts its
    sum from 0)."""
    CN, _, _, U = bufs.shape
    dh = carry.clone()
    for b in range(CN):
        for c in range(CN):
            dh[:, b * U:(b + 1) * U] = dh[:, b * U:(b + 1) * U] + bufs[b, c]
    return dh


def simt_bwd_step(op_dg, staged, carry, H):
    """dh (N, H) of one step of the simt design for all N rows: row tiles of
    R rows (the last padded with zero rows), each through
    ``simt_bwd_partials`` and, half by half, ``simt_bwd_dh``."""
    m = bigru_vjp.simt_bwd_geometry(H)
    R, R0 = m["R"], m["R0"]
    N = op_dg.shape[0]
    dh = torch.empty((N, H))
    for r0 in range(0, N, R):
        n = min(R, N - r0)
        op_tile, c_tile = torch.zeros((R, op_dg.shape[1])), torch.zeros((R, H))
        op_tile[:n], c_tile[:n] = op_dg[r0:r0 + n], carry[r0:r0 + n]
        tile = torch.cat([simt_bwd_dh(bufs, c_tile[h * R0:h * R0 + bufs.shape[2]])
                          for h, (bufs, _imgs) in
                          enumerate(simt_bwd_partials(op_tile, staged, H))])
        dh[r0:r0 + n] = tile[:n]
    return dh


def _k5_staged(dout, x, w_ih, w_hh, out, gates, compute_dtype, U, design):
    """K5's arithmetic in plain PyTorch, in the kernel's layout: per step, each
    CTA c of the cluster multiplies its own 3U columns of op(dhg) by its
    staged W_hh slice into a partial dh for all H units; the owner of units
    [c'U, (c'+1)U) adds dt z and the CN partials in rank order (simt: through
    the operand images and buffers of ``simt_bwd_step``). dx and the weight
    gradients as single products after the recurrence."""
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
        r, z, n, hgn = (g[..., k * H:(k + 1) * H] for k in range(4))
        o = out[..., d * H:(d + 1) * H].float()
        h_prev = torch.zeros_like(o)
        if d == 0:
            h_prev[1:] = o[:-1]
        else:
            h_prev[:-1] = o[1:]
        staged = op(stage_k5(w_hh[d], U, design))
        dxg_all = torch.empty((L, N, 3 * H))
        dhg_all = torch.empty((L, N, 3 * H))
        dh = torch.zeros((N, H))
        for s in range(L):
            t = L - 1 - s if d == 0 else s
            dt = dout[t, :, d * H:(d + 1) * H].float() + dh
            dz = dt * (h_prev[t] - n[t]) * z[t] * (1.0 - z[t])
            dn = dt * (1.0 - z[t]) * (1.0 - n[t] * n[t])
            dr = dn * hgn[t] * r[t] * (1.0 - r[t])
            dxg_all[t] = torch.cat([dr, dz, dn], dim=1)
            dhg = torch.cat([dr, dz, dn * r[t]], dim=1)
            dhg_all[t] = dhg
            dh = dt * z[t]
            if design == "simt":
                dh = simt_bwd_step(op(dhg), staged, dh, H)
                continue
            for c in range(cn):
                a = op(dhg[:, own_columns(H, U, c)])
                dh = dh + a @ staged[c].T
        dxg_all = dxg_all.reshape(L * N, 3 * H)
        dhg_all = dhg_all.reshape(L * N, 3 * H)
        dx += op(dxg_all) @ op(w_ih[d]).T
        grads.append((xs.T @ op(dxg_all), dxg_all.sum(0),
                      h_prev.reshape(L * N, H).T @ op(dhg_all), dhg_all.sum(0)))
    dw_ih, db_ih, dw_hh, db_hh = (torch.stack([gr[i] for gr in grads]) for i in range(4))
    return dx.reshape(L, N, C), dw_ih, db_ih, dw_hh, db_hh


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("hidden,design", [(16, "simt"), (64, "simt"), (64, "tc"),
                                           (128, "tc")])
def test_staged_backward_equals_plain(hidden, design, dtype):
    """fp32 to 1e-5 (1e-5 of max|ref| for the sums over L*N rows); bf16 to
    1e-2 of max|ref|, where an f32 sum in another order rounds a gate
    gradient operand to the neighbouring bf16 value."""
    dt = getattr(torch, dtype)
    U = min(hidden, 32) if design == "simt" else 64
    rng = np.random.RandomState(hidden)
    wih, bih, whh, bhh = layer_weights(init_rnn_params(rng, 11, hidden, 1)[0], dt)
    x = torch.from_numpy(rng.randn(6, 5, 11).astype(np.float32)).to(dt)
    dout = torch.from_numpy(rng.randn(6, 5, 2 * hidden).astype(np.float32)).to(dt)
    out, gates = bigru_vjp.bigru_layer_train_fwd_plain(x, wih, bih, whh, bhh, dt)
    got = _k5_staged(dout, x, wih, whh, out, gates, dt, U, design)
    ref = bigru_vjp.bigru_layer_bwd_plain(dout, x, wih, whh, out, gates, dt)
    for name, a, r in zip(("dx", "dw_ih", "db_ih", "dw_hh", "db_hh"), got, ref):
        scale = max(1.0, r.abs().max().item())
        tol = (1e-5 if dt == torch.float32 else 1e-2) * scale
        assert a.shape == r.shape and (a - r).abs().max().item() <= tol, name


def test_staging_model_follows_the_kernel_source():
    """The model above is the kernel's staging loops and its reduce: W_hh row
    j, column gate*H + u0 + u goes to shared row k = gate*U + u (simt,
    [k][j]) or to row j, column k (tc, [j][k]), u0 = rank * U; the owner adds
    the partials of ranks 0 .. CN-1 in order."""
    path = os.path.join(os.path.dirname(bigru_vjp.__file__), "csrc", "rnn_train_rec.cuh")
    with open(path) as f:
        src = " ".join(f.read().split())
    for line in ("const int j = i % H, k4 = (i / H) * 4;",
                 "const int gate = k4 / U, u = k4 % U;",
                 "Op<T>::load4(W + (size_t)j * G + gate * H + u0 + u, v);",
                 "for (int e = 0; e < 4; ++e) ws[(k4 + e) * H + j] = v[e];",
                 "const int j = i / (UG / 8), k8 = (i % (UG / 8)) * 8;",
                 "const int gate = k8 / U, u = k8 % U;",
                 "*reinterpret_cast<uint4*>(wb + j * DS + k8) = __ldg(reinterpret_cast<const "
                 "uint4*>( W + (size_t)j * G + gate * H + u0 + u));",
                 "for (uint32_t c = 0; c < cn; ++c) dh += rcv[(size_t)c * R * U + q];",
                 "for (int c = 0; c < CN; ++c) dh += f4_at(part[c], e);",
                 "const int u0 = crank * U;"):
        assert line in src, line


@pytest.mark.parametrize("hidden", [16, 32, 64, 128, 256])
def test_simt_bwd_maps_cover_each_pair_and_partial_once(hidden):
    """The simt backward's 256 threads: each row half's gate-math quads
    cover its rows x U (row, unit) pairs once, at most QM quads a thread;
    the product's tiles cover the R x H partial once, a thread's first RT0
    rows in the first half and the rest in the second; each 4-unit half of
    a tile lies in one owner's U units, so a peer's threads store every
    (row, unit) of an owner's slot of a half once: the bytes that owner's
    `full` barrier expects of each peer, rows x U x 4."""
    m = simt_bwd_maps(hidden)
    U, CN, R, R0, RT0 = m["U"], m["CN"], m["R"], m["R0"], m["RT0"]
    assert m["NH"] == (2 if m["RT"] > 1 else 1) and (m["NH"] == 2 or R0 == R)
    qm = 0
    for h, quads in enumerate(m["quads"]):
        rh = R0 if h == 0 else R - R0
        cover = np.zeros((rh, U), int)
        np.add.at(cover, (quads[:, 1:2], quads[:, 2:3] + np.arange(4)), 1)
        assert (cover == 1).all()
        qm = max(qm, np.bincount(quads[:, 0], minlength=256).max())
    assert qm == m["QM"] <= 2
    tiles = np.zeros((R, hidden), int)
    np.add.at(tiles, (m["tile_rows"][:, :, None], m["tile_units"][:, None, :]), 1)
    assert (tiles == 1).all()
    assert (m["tile_rows"][:, :RT0] < R0).all() and (m["tile_rows"][:, RT0:] >= R0).all()
    owners = m["tile_units"] // U
    assert (owners[:, :4] == owners[:, :1]).all() and (owners[:, 4:] == owners[:, 4:5]).all()
    for h in range(m["NH"]):
        rows = m["tile_rows"][:, :RT0] if h == 0 else m["tile_rows"][:, RT0:]
        for b in range(CN):  # one peer's stores into owner b's slot of the half
            got = np.zeros((R, U), int)
            for e2 in range(2):
                mine = owners[:, 4 * e2] == b
                np.add.at(got, (rows[mine][:, :, None],
                                (m["tile_units"][mine][:, None, 4 * e2:4 * e2 + 4] % U)), 1)
            want = np.zeros((R, U), int)
            want[(R0 * h):(R0 * h + rows.shape[1] * m["NR"])] = 1
            assert (got == want).all()
    assert m["tile_units"].min() % 4 == 0 and (m["tile_units"] % 4 == np.arange(8) % 4).all()


@pytest.mark.parametrize("ng", [3, 4])
@pytest.mark.parametrize("hidden", [16, 32, 64, 128, 256])
def test_simt_bwd_buffers_give_the_rank_order_sum(hidden, ng):
    """One step of the exchange on integer-valued operands and weights, where
    every order of the sums is exact: for each row half, each CTA's operand
    image holds its own gate columns k = gate U + u at the half's local row
    (zero padding), every slot of every owner's buffer is written (no NaN
    left), and the owners' rank-order sums are dh = carry + op(dg) W_hh^T
    exactly."""
    rng = np.random.RandomState(hidden + ng)
    m = simt_bwd_maps(hidden)
    U, CN, R, R0 = m["U"], m["CN"], m["R"], m["R0"]
    w = torch.from_numpy(rng.randint(-3, 4, (hidden, ng * hidden)).astype(np.float32))
    op_tile = torch.from_numpy(rng.randint(-3, 4, (R, ng * hidden)).astype(np.float32))
    carry = torch.from_numpy(rng.randint(-3, 4, (R, hidden)).astype(np.float32))
    staged = torch.stack([w[:, own_columns(hidden, U, c, ng)].T for c in range(CN)])
    halves = simt_bwd_partials(op_tile, staged, hidden)
    assert len(halves) == m["NH"]
    for h, (bufs, imgs) in enumerate(halves):
        lo, rh = h * R0, bufs.shape[2]
        assert not torch.isnan(bufs).any()
        for c in range(CN):
            assert torch.equal(imgs[c][:rh, :ng * U],
                               op_tile[lo:lo + rh, own_columns(hidden, U, c, ng)])
            assert not imgs[c][:, ng * U:].any()
        want = carry[lo:lo + rh] + op_tile[lo:lo + rh] @ w.T
        assert torch.equal(simt_bwd_dh(bufs, carry[lo:lo + rh]), want)


def test_simt_bwd_rows_follow_the_occupancy_rule():
    """R at H = 256 is the least multiple of 8 (the thread layout's 8 row
    groups) whose 1,024-row tiles fill the fewest waves of 15 resident
    clusters of 8 and whose CTA fits in shared memory, for both cells: 72
    rows, 15 tiles a direction, 2 waves (64 rows take 3; the LSTM's CTA of
    80 rows would need 234,144 bytes); the source's K56_RT256 is the
    planner's."""
    rows, clusters = 1024, 15  # the train path's rows; resident clusters on the H100

    def waves(R):
        return bigru_vjp.rec_waves(R, rows, clusters)

    fits = [R for R in range(8, 257, 8)
            if max(bigru_vjp.k5_smem("simt", 256, 32, R, ng) for ng in (3, 4)) <= SMEM_LIMIT]
    best = min(fits, key=lambda R: (waves(R), R))
    assert best == 72 == bigru_vjp.simt_bwd_geometry(256)["R"]
    assert (waves(72), waves(64)) == (2, 3)
    assert bigru_vjp.k5_smem("simt", 256, 32, 80, 4) == 234144 > SMEM_LIMIT
    path = os.path.join(os.path.dirname(bigru_vjp.__file__), "csrc", "rnn_train_rec.cuh")
    with open(path) as f:
        assert "#define K56_RT256 {}\n".format(bigru_vjp.SIMT_BWD_RT256) in f.read()


def test_simt_bwd_model_follows_the_kernel_source():
    """The maps and the exchange of ``simt_bwd_maps`` / ``simt_bwd_partials``
    are the kernel's: its geometry and row halves, the pairs' and tiles'
    indices, the operand image [local row][k U + u] of row stride NG U + 4
    that the halves share, the owner and slot of each 4-unit half of a
    partial in the half's buffer, the arrivals each owner counts, and the
    shared memory's parts."""
    path = os.path.join(os.path.dirname(bigru_vjp.__file__), "csrc", "rnn_train_rec.cuh")
    with open(path) as f:
        src = " ".join(f.read().split())
    for line in ("static constexpr int U = H < 32 ? H : 32;",
                 "static constexpr int JG = H / 8;",
                 "static constexpr int JL = JG < 8 ? JG : 8;",
                 "static constexpr int NJW = JG / JL;",
                 "static constexpr int NRW = 8 / NJW;",
                 "static constexpr int NR = NRW * (32 / JL);",
                 "static constexpr int RT = H == 256 ? K56_RT256 : CN;",
                 "static constexpr int R = NR * RT;",
                 "static constexpr int NH = RT > 1 ? 2 : 1;",
                 "static constexpr int RT0 = NH == 2 ? (RT + 1) / 2 : RT;",
                 "constexpr int U = Gm::U, CN = Gm::CN, UG = NG * U, DS = UG + 4, G = NG * H;",
                 "constexpr int NH = Gm::NH, RT0 = Gm::RT0, R0 = NR * RT0;",
                 "constexpr int UQ = U / 4;",
                 "const int g = tid + REC_THREADS * j;",
                 "const int row = row0 + h * R0 + g / UQ, unit = u0 + 4 * (g % UQ);",
                 "const int rl = g / UQ, u = 4 * (g % UQ), row = row0 + h * R0 + rl;",
                 "const int jg = (warp % NJW) * JL + lane % JL;",
                 "const int rg = (warp / NJW) * (32 / JL) + lane / JL;",
                 "const int jo[2] = {4 * jg, H / 2 + 4 * jg};",
                 "const int ni = h ? RT - RT0 : RT0;",
                 "float* rcv = recv + h * CN * R0 * U;",
                 "part[c] = *reinterpret_cast<const float4*>(rcv + (c * rh + rl) * U + u);",
                 "for (int c = 0; c < CN; ++c) dh += f4_at(part[c], e);",
                 "*reinterpret_cast<float4*>(opb + (g / UQ) * DS + k * U + 4 * (g % UQ)) =",
                 "const int hn = h + 1 < NH ? h + 1 : 0, sn = h + 1 < NH ? s : s + 1;",
                 "w[kk][e] = *reinterpret_cast<const float4*>(ws + (k + kk) * H + jo[e]);",
                 "const float4 av = *reinterpret_cast<const float4*>(opb + (rg + i * NR) * DS + k);",
                 "acc[i][4 * e + 0] = fmaf(a[kk], w[kk][e].x, acc[i][4 * e + 0]);",
                 "const uint32_t own = (uint32_t)(jo[e] / U);",
                 "const int ju = jo[e] % U;",
                 "const uint32_t la = smem_u32(rcv + (crank * rh + rg + i * NR) * U + ju);",
                 "mbar_init(full_bar[h], 1);",
                 "if (s + 1 < L) mbar_expect_tx(full_bar[h], (CN - 1) * rh * U * 4);",
                 "st_async_v4(la, full_bar[h], own, val);",
                 "if constexpr (!LSTM) dh = carry[h][j][e];",
                 "carry[h][j][e] = __fmul_rn(dt, zg);",
                 "m.dg = m.recv + (size_t)cn * R * U * 4;",
                 "m.dh = m.dg + (size_t)nr * rt0 * (UG + 4) * 4;"):
        assert line in src, line


@pytest.mark.parametrize("hidden", [16, 64])
def test_simt_staged_backward_equals_the_jax_layer(hidden):
    """The simt model (``_k5_staged``) against the JAX package's
    ``fused_bigru_layer_tm`` (through ``birnn_apply_pallas_trainable``, one
    layer, b_tile 8, interpret mode) on the same numpy weights, inputs and
    cotangent: tests/test_torch_bigru_vjp.py's gate, atol 2e-4 / rtol 1e-3
    (f32 sums in other orders, the JAX kernel's bwd half in reversed time)."""
    import jax
    import jax.numpy as jnp

    from ccsmeth_tpu.ops.bigru_pallas_vjp import birnn_apply_pallas_trainable

    rng = np.random.RandomState(hidden + 7)
    layers = init_rnn_params(rng, 11, hidden, 1)
    x = rng.randn(5, 6, 11).astype(np.float32)  # (N, L, C)
    cot = rng.randn(5, 6, 2 * hidden).astype(np.float32)

    def loss(x_, ls):
        out, _ = birnn_apply_pallas_trainable(ls, x_, b_tile=8, interpret=True)
        return jnp.sum(out * cot)

    gx, gl = jax.grad(loss, argnums=(0, 1))(jnp.asarray(x), layers)
    wih, bih, whh, bhh = layer_weights(layers[0])
    xt = torch.from_numpy(x).transpose(0, 1).contiguous()
    dout = torch.from_numpy(cot).transpose(0, 1).contiguous()
    out, gates = bigru_vjp.bigru_layer_train_fwd_plain(xt, wih, bih, whh, bhh)
    dx, dw_ih, db_ih, dw_hh, db_hh = _k5_staged(dout, xt, wih, whh, out, gates,
                                                torch.float32, min(hidden, 32), "simt")
    np.testing.assert_allclose(dx.transpose(0, 1).numpy(), np.asarray(gx), atol=2e-4, rtol=1e-3)
    for d, name in enumerate(("fwd", "bwd")):
        want = gl[0][name]
        for got, key, tr in ((dw_ih[d], "w_ih", True), (dw_hh[d], "w_hh", True),
                             (db_ih[d], "b_ih", False), (db_hh[d], "b_hh", False)):
            np.testing.assert_allclose((got.T if tr else got).numpy(), np.asarray(want[key]),
                                       atol=2e-4, rtol=1e-3, err_msg=key)


def _counts():
    return (bigru_vjp.launches_fwd, bigru_vjp.launches_bwd, bigru_vjp.cuda_launches,
            dict(bigru_vjp.design_calls))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cpu_train_kernels_launch_nothing(dtype):
    """On CPU tensors K4 and K5 run their plain versions: two plain calls and
    no kernel call, design or CUDA launch."""
    dt = getattr(torch, dtype)
    rng = np.random.RandomState(9)
    wih, bih, whh, bhh = layer_weights(init_rnn_params(rng, 11, 16, 1)[0], dt)
    x = torch.from_numpy(rng.randn(4, 3, 11).astype(np.float32)).to(dt)
    dout = torch.from_numpy(rng.randn(4, 3, 32).astype(np.float32)).to(dt)
    before, plain = _counts(), bigru_vjp.plain_calls
    out, gates = bigru_vjp.bigru_layer_train_fwd(x, wih, bih, whh, bhh, dt)
    grads = bigru_vjp.bigru_layer_bwd(dout, x, wih, whh, out, gates, dt)
    assert _counts() == before and bigru_vjp.plain_calls == plain + 2
    assert len(grads) == 5 and all(bool(torch.isfinite(g).all()) for g in grads)


def wgrad_residency(kernel):
    """CTAs an SM of a weight-gradient kernel: its __launch_bounds__ in
    csrc/rnn_train_gemm.cuh."""
    path = os.path.join(os.path.dirname(bigru_vjp.__file__), "csrc", "rnn_train_gemm.cuh")
    with open(path) as f:
        src = " ".join(f.read().split())
    threads = {"gemm_simt_kernel": "GM_THREADS", "wgemm_kernel": "WG_THREADS",
               "f32_tma_kernel": "FT_THREADS"}[kernel]
    bounds = "__launch_bounds__({}, ".format(threads)
    i = src.index(kernel + "(")
    j = src.rindex(bounds, 0, i)
    return int(src[j + len(bounds):src.index(")", j)])


@pytest.mark.parametrize("cin,kernel,slices", [
    (512, "gemm_simt_kernel", 11), (11, "gemm_simt_kernel", 22),
    (512, "wgemm_kernel", 11), (11, "wgemm_kernel", 22),
    (512, "f32_tma_kernel", 11), (11, "f32_tma_kernel", 22)])
def test_k5_wgrad_slices_fill_whole_waves(cin, kernel, slices):
    """1024 rows, H = 256, 132 SMs: the slices whose tiles fill the last wave
    of blocks, 2 an SM for the weight-gradient kernel of either design (simt:
    f32_tma_kernel on f32, gemm_simt_kernel on bf16; tc: wgemm_kernel); e.g. 11 x 72 tiles = 3 full waves
    of 264 blocks, where 4 slices (288 blocks) would leave a second wave of
    24."""
    assert wgrad_residency(kernel) == bigru_vjp.WGRAD_CTAS_PER_SM == 2
    S = bigru_vjp.k5_wgrad_slices(21 * 1024, cin, 256, 132)
    assert S == slices
    tiles = 2 * 6 * (-(-cin // 128) + 2)
    slots = 2 * 132
    assert (S * tiles) % slots == 0


def test_k5_wgrad_slices_keep_256_rows_a_slice():
    assert bigru_vjp.k5_wgrad_slices(21 * 13, 11, 16, 132) == 1
    assert bigru_vjp.k5_wgrad_slices(21 * 65, 11, 32, 132) <= 21 * 65 // 256


# ---- the tc design's backward products on wgmma (csrc/rnn_train_gemm.cuh's
# wgemm_kernel): the operand images TMA writes under the 128-byte swizzle,
# read back as the wgmma descriptors address them

WG_BM, WG_BK, WG_BOX = 128, 64, 8192  # WG_BM, WG_BK, WG_BOX in the source


def swizzle128(addr):
    """The 128-byte swizzle (TMA's writes, wgmma's reads) of a byte address
    from a 1024-byte-aligned base: bits [7, 10) XOR into bits [4, 7)."""
    return addr ^ (((addr >> 7) & 7) << 4)


def tma_box(t, c0, c1, rows):
    """The box of 64 columns by ``rows`` rows of the 2-D tensor t at column
    c0, row c1 (signed), as TMA writes it: flat slots (one a bf16) of rows of
    128 bytes under the swizzle, elements outside t zero."""
    R, W = t.shape
    j, i = torch.arange(rows).view(-1, 1), torch.arange(64).view(1, -1)
    r, c = c1 + j, c0 + i
    inside = (r >= 0) & (r < R) & (c >= 0) & (c < W)
    vals = torch.where(inside, t[r.clamp(0, R - 1), c.clamp(0, W - 1)], torch.zeros(()))
    img = torch.zeros(rows * 64)
    img[swizzle128(j * 128 + 2 * i) // 2] = vals
    return img


def kmajor_read(img, start, rows, k):
    """(rows, k) elements of a K-major operand of 128-byte rows (8-row atoms
    of 1,024 bytes, SBO 1,024): (r, k) at start + (r // 8) 1024 + (r % 8) 128
    + 2 k, each k16 step 32 bytes further."""
    r, kk = torch.arange(rows).view(-1, 1), torch.arange(k).view(1, -1)
    return img[swizzle128(start + (r // 8) * 1024 + (r % 8) * 128 + 2 * kk) // 2]


def mnmajor_read(img, start, mn, k):
    """(mn, k) elements of an MN-major operand (A through trans-a, B through
    trans-b): (m, k) at start + (m // 64) LBO + (k // 8) SBO + (k % 8) 128 +
    2 (m % 64), LBO = one 64 x 64 box (8,192 bytes), SBO = 8 k rows (1,024),
    each k16 step 2,048 bytes further."""
    m, kk = torch.arange(mn).view(-1, 1), torch.arange(k).view(1, -1)
    addr = start + (m // 64) * WG_BOX + (kk // 8) * 1024 + (kk % 8) * 128 + 2 * (m % 64)
    return img[swizzle128(addr) // 2]


def wgemm_dx(g16, wih):
    """wgemm_kernel<false, BN>'s dx (M, C) = sum_d g16[d] (M, G) wih[d]^T,
    tile by tile: a CTA's 128 rows (two warpgroups of 64) by BN columns, k
    tiles of 64 of each direction in turn, both operands K-major boxes."""
    _, M, G = g16.shape
    C = wih.shape[1]
    BN = 16 if C <= 16 else 32 if C <= 32 else 64 if C <= 64 else 128
    dx = torch.zeros((-(-M // WG_BM)) * WG_BM, (-(-C // BN)) * BN)
    for m0 in range(0, M, WG_BM):
        for n0 in range(0, C, BN):
            acc = torch.zeros(WG_BM, BN)
            for d in (0, 1):
                for k0 in range(0, G, WG_BK):
                    a = tma_box(g16[d], k0, m0, WG_BM)
                    b = tma_box(wih[d], k0, n0, BN)
                    bk = torch.cat([kmajor_read(b, 32 * kk, BN, 16) for kk in range(4)], 1)
                    for wg in (0, 1):
                        ak = torch.cat([kmajor_read(a, wg * WG_BOX + 32 * kk, 64, 16)
                                        for kk in range(4)], 1)
                        acc[64 * wg:64 * wg + 64] += ak @ bk.T
            dx[m0:m0 + WG_BM, n0:n0 + BN] = acc
    return dx[:M, :C]


def wgemm_dw(a_t, a_col, a_row, g16, M, S):
    """wgemm_kernel<true, 128>'s dW (M, G) = A^T g16 over the rows k of
    g16 (LN, G) in S slices (Ks rows each, a multiple of 64), summed in
    slice order: A (m, k) = a_t[a_row + k, a_col + m] (zero outside a_t),
    both operands MN-major, two 64-column boxes each. Returns (dW, the A
    images of each slice's first k tile)."""
    LN, G = g16.shape
    Ks = -(-(-(-LN // S)) // WG_BK) * WG_BK
    parts, firsts = [], []
    for sl in range(S):
        kb, ke = sl * Ks, min(LN, sl * Ks + Ks)
        part = torch.zeros((-(-M // WG_BM)) * WG_BM, (-(-G // 128)) * 128)
        for m0 in range(0, M, WG_BM):
            for n0 in range(0, G, 128):
                for k0 in range(kb, ke, WG_BK):
                    a = torch.cat([tma_box(a_t, a_col + m0 + 64 * h, a_row + k0, WG_BK)
                                   for h in (0, 1)])
                    b = torch.cat([tma_box(g16, n0 + 64 * h, k0, WG_BK) for h in (0, 1)])
                    if (m0, n0, k0) == (0, 0, kb):
                        firsts.append(a)
                    bk = torch.cat([mnmajor_read(b, 2048 * kk, 128, 16) for kk in range(4)], 1)
                    for wg in (0, 1):
                        ak = torch.cat([mnmajor_read(a, wg * WG_BOX + 2048 * kk, 64, 16)
                                        for kk in range(4)], 1)
                        part[m0 + 64 * wg:m0 + 64 * wg + 64, n0:n0 + 128] += ak @ bk.T
        parts.append(part[:M, :G])
    dw = torch.zeros(M, G)
    for part in parts:
        dw += part
    return dw, firsts


def x_route(C):
    """How wgemm_kernel's producer brings X's rows for dW_ih: TMA where they
    are 16-byte multiples (C % 8 == 0), else plain loads into the same
    swizzled image (``stage_rows_mn``)."""
    return "tma" if C % 8 == 0 else "plain"


def stage_rows_mn(x, k0, m0):
    """csrc/rnn_train_gemm.cuh's stage_rows_mn: rows [k0, k0 + 64) of X (K,
    C) at columns [m0, m0 + 128), chunk c8 (8 columns) of row r of box h at
    h WG_BOX + 128 r + 16 (c8 ^ (r % 8)), zero outside X."""
    K, C = x.shape
    img = torch.zeros(2 * WG_BOX // 2)
    for r in range(WG_BK):
        for h in (0, 1):
            for c8 in range(8):
                m = m0 + 64 * h + 8 * c8
                for e in range(8):
                    if k0 + r < K and m + e < C:
                        img[(h * WG_BOX + 128 * r + 16 * (c8 ^ (r & 7)) + 2 * e) // 2] = \
                            x[k0 + r, m + e]
    return img


def gru_gate_grads(dout, x, w_hh, out, gates, compute_dtype):
    """The f32 gate gradients dxg and dhg (2, L N, 3H) of
    ``bigru_layer_bwd_plain``'s loop, in its order: what the tc recurrence
    rounds to bf16 for the products and sums unrounded for the biases."""
    from ccsmeth_tpu_torch.ops.kernel_args import op

    L, N, _ = x.shape
    H = w_hh.shape[1]
    gx, gh = torch.empty((2, L, N, 3 * H)), torch.empty((2, L, N, 3 * H))
    for d in (0, 1):
        g = gates[d].float()
        r, z, n, hgn = (g[..., k * H:(k + 1) * H] for k in range(4))
        o = out[..., d * H:(d + 1) * H].float()
        h_prev = torch.zeros_like(o)
        if d == 0:
            h_prev[1:] = o[:-1]
        else:
            h_prev[:-1] = o[1:]
        w_hhT = op(w_hh[d], compute_dtype).T
        dh = torch.zeros((N, H))
        for s in range(L):
            t = L - 1 - s if d == 0 else s
            dt = dout[t, :, d * H:(d + 1) * H].float() + dh
            dz = dt * (h_prev[t] - n[t]) * z[t] * (1.0 - z[t])
            dn = dt * (1.0 - z[t]) * (1.0 - n[t] * n[t])
            dr = dn * hgn[t] * r[t] * (1.0 - r[t])
            gx[d, t] = torch.cat([dr, dz, dn], dim=1)
            gh[d, t] = torch.cat([dr, dz, dn * r[t]], dim=1)
            dh = dt * z[t] + op(gh[d, t], compute_dtype) @ w_hhT
    return gx.reshape(2, L * N, 3 * H), gh.reshape(2, L * N, 3 * H)


def sum_tol(a, b):
    """An f32 sum of the same products in another order: 1e-5 of the largest
    sum of their magnitudes."""
    return 1e-5 * (a.abs() @ b.abs()).max().item() + 1e-6


def tile_bias_sums(g, N, rows=32):
    """The tc recurrence's bias gradients: each row tile's (``rows`` rows of
    N, every step) partial column sums of the f32 gate gradient g (2, L N,
    G), then the partials added in tile order (gemm_sum_slices)."""
    L = g.shape[1] // N
    gt = g.view(2, L, N, -1)
    db = torch.zeros(2, g.shape[2])
    for r0 in range(0, N, rows):
        db += gt[:, :, r0:r0 + rows].sum(dim=(1, 2))
    return db


def check_wgmma_products(x, out, wih, gx16, gh16, ref, S=2):
    """dx, dW_ih and dW_hh from the operand images (``wgemm_dx``,
    ``wgemm_dw``; X's image, where TMA cannot write it, as
    ``stage_rows_mn`` writes it, equal to the box TMA would write)
    against the plain backward's ``ref`` (dx, dw_ih, _, dw_hh, _) within
    ``sum_tol``; h_prev's images read zeros before each direction's first
    step (d 0: rows k - N < 0; d 1: rows k + N >= L N)."""
    L, N, C = x.shape
    H = out.shape[2] // 2
    LN = L * N
    xs, o2 = x.float().reshape(LN, C), out.float().reshape(LN, 2 * H)
    a = torch.cat([gx16[0], gx16[1]], dim=1)
    b = torch.cat([wih[0].float().T, wih[1].float().T], dim=0)
    dx = wgemm_dx(gx16, wih.float())
    assert (dx - ref[0].reshape(LN, C)).abs().max().item() <= sum_tol(a, b), "dx"
    for d in (0, 1):
        dw_ih, x_imgs = wgemm_dw(xs, 0, 0, gx16[d], C, S)
        if x_route(C) == "plain":
            Ks = -(-(-(-LN // S)) // WG_BK) * WG_BK
            for sl, img in enumerate(x_imgs):
                assert torch.equal(stage_rows_mn(xs, sl * Ks, 0), img), ("x image", sl)
        assert (dw_ih - ref[1][d]).abs().max().item() <= sum_tol(xs.T, gx16[d]), ("dw_ih", d)
        shift = -N if d == 0 else N
        dw_hh, firsts = wgemm_dw(o2, d * H, shift, gh16[d], H, S)
        h_prev = torch.zeros(LN, H)
        if d == 0:
            h_prev[N:] = o2[:-N, :H]
        else:
            h_prev[:-N] = o2[N:, H:]
        assert (dw_hh - ref[3][d]).abs().max().item() <= sum_tol(h_prev.T, gh16[d]), \
            ("dw_hh", d)
        # the first k tile of each slice, as wgmma reads it: (m, k) = out's
        # row kb + k + shift, column d H + m, zero where the row falls
        # outside out (h_prev there, where k < L N)
        Ks = -(-(-(-LN // S)) // WG_BK) * WG_BK
        mh = min(H, 64)
        for sl, img in enumerate(firsts):
            rows = torch.arange(sl * Ks, sl * Ks + WG_BK) + shift
            ok = (rows >= 0) & (rows < LN)
            want = torch.zeros(WG_BK, mh)
            want[ok] = o2[rows[ok], d * H:d * H + mh]
            assert torch.equal(mnmajor_read(img, 0, mh, WG_BK), want.T), ("h_prev", d, sl)
            k = torch.arange(sl * Ks, sl * Ks + WG_BK)
            inside = k < LN
            assert torch.equal(want[inside], h_prev[k[inside], :mh]), ("h_prev", d, sl)
        # the direction's first step reads zeros: d 0 the first N rows of
        # the first tile (d 1's, rows past L N, are the zeros of ``want``)
        if d == 0:
            first = mnmajor_read(firsts[0], 0, mh, WG_BK)
            assert bool(first[:, N:].abs().sum() > 0)
            assert torch.equal(first[:, :N], torch.zeros(mh, min(N, WG_BK)))


@pytest.mark.parametrize("cin", [11, 28, 512])
@pytest.mark.parametrize("hidden", [32, 256])
def test_wgmma_operand_images_give_the_plain_gradients(hidden, cin):
    """K5's tc products from the images TMA writes of the bf16 gate
    gradients, W_ih, X and the shifted h_prev, read as wgmma's descriptors
    address them, tile by tile as wgemm_kernel runs them (two row slices, a
    ragged last k tile), against ``bigru_layer_bwd_plain`` at bf16; the bias
    gradients from the recurrence's row-tile partials in tile order."""
    dt = torch.bfloat16
    L, N = 4, 40
    rng = np.random.RandomState(hidden + cin)
    wih, bih, whh, bhh = layer_weights(init_rnn_params(rng, cin, hidden, 1)[0], dt)
    x = torch.from_numpy(rng.randn(L, N, cin).astype(np.float32)).to(dt)
    dout = torch.from_numpy(rng.randn(L, N, 2 * hidden).astype(np.float32)).to(dt)
    out, gates = bigru_vjp.bigru_layer_train_fwd_plain(x, wih, bih, whh, bhh, dt)
    ref = bigru_vjp.bigru_layer_bwd_plain(dout, x, wih, whh, out, gates, dt)
    gx, gh = gru_gate_grads(dout, x, whh, out, gates, dt)
    check_wgmma_products(x, out, wih, gx.to(dt).float(), gh.to(dt).float(), ref)
    ones = torch.ones(1, L * N)
    for k, (g, db) in enumerate(((gx, ref[2]), (gh, ref[4]))):
        got = tile_bias_sums(g, N)
        for d in (0, 1):
            assert (got[d] - db[d]).abs().max().item() <= sum_tol(ones, g[d]), ("db", k, d)


def test_wgmma_model_follows_the_kernel_source():
    """The model above is wgemm_kernel's: its tile constants, two CTAs an SM
    (``wgrad_residency``), the descriptors (K-major 128-byte
    rows, k16 steps of 32 bytes; MN-major with LBO one box, SBO 8 k rows,
    k16 steps of 2,048 bytes, trans-a and trans-b), the boxes' coordinates
    (h_prev at row k -+ N of out, columns d H ..), BN by C, and X's rows by
    TMA only where C % 8 == 0, else by the plain loads modelled by
    ``stage_rows_mn``."""
    path = os.path.join(os.path.dirname(bigru_vjp.__file__), "csrc", "rnn_train_gemm.cuh")
    with open(path) as f:
        src = " ".join(f.read().split())
    for line in ("#define WG_BM {}".format(WG_BM), "#define WG_BK {}".format(WG_BK),
                 "#define WG_BOX {}".format(WG_BOX),
                 "mnmajor_desc(a + 2048 * kk, WG_BOX, 1024), mnmajor_desc(b + 2048 * kk, WG_BOX, "
                 "1024)",
                 "Wgmma<BN>::template mma<1, 1>", "Wgmma<BN>::template mma<0, 0>",
                 "kmajor_desc(a + 32 * kk, 128), kmajor_desc(b + 32 * kk, 128)",
                 "base + s * STAGE + wg * WG_BOX",
                 "tma_load_2d(a + WG_BOX, am, bar, jb.a_col + m0 + 64, jb.a_row + k0);",
                 "tma_load_3d(b + WG_BOX, bm, bar, n0 + 64, k0, jb.b_dir);",
                 "tma_load_3d(a, am, bar, k0, m0, d);", "tma_load_3d(b, bm, bar, k0, n0, d);",
                 "WgJob{part + 2LL * C * G + (size_t)d * H * G, H, 1, d * H, d == 0 ? -N : N, 1, d}",
                 "const int BN = C <= 16 ? 16 : C <= 32 ? 32 : C <= 64 ? 64 : 128;",
                 "p.Ks = slice_rows(LN, S, WG_BK);"):
        assert line in src, line
    for line in ("const bool x_tma = C % 8 == 0;",
                 "p.job[d] = WgJob{part + (size_t)d * C * G, C, x_tma ? 0 : 2, 0, 0, 0, d};",
                 "st_shared_v4(a + h * WG_BOX + r * 128 + ((c8 ^ (r & 7)) << 4),",
                 "stage_rows_mn(a, p.x, jb.M, p.K, k0, m0, lane);"):
        assert line in src, line
    assert [x_route(c) for c in (11, 21, 28, 52, 64, 512)] == \
        ["plain", "plain", "plain", "plain", "tma", "tma"]


# ---- the simt forward recurrence (csrc/rnn_train_rec.cuh::fwd_rec_simt_kernel):
# its thread map, its h blocks and their exchange, the `full` / `empty`
# protocol with the warp groups' turns, and a plain forward in its layout

def fwd_row(rt, nq, q, i):
    """``fwd_row`` of the source: row i of the thread in row slot q, local to
    its group's rows (nq slots of rt rows): quads of consecutive rows first
    (quad j: rows 4 (j nq + q) ..), then one row a slot."""
    qa = rt // 4 * 4
    return (i // 4 * nq + q) * 4 + i % 4 if i < qa else qa * nq + (i - qa) * nq + q


def simt_fwd_maps(H, rt=0):
    """The simt forward's thread map at H and RT rows a thread (``rt``, or
    the default tile's), as fwd_rec_simt_kernel computes it from tid: each
    thread's warp group (``group``), unit (local, ``unit``), row slot in its
    group (``slot``) and rows local to its group's (``rows``, (256, RT));
    the group's rows of the tile start at group RG."""
    g = bigru_vjp.simt_fwd_geometry(H, rt)
    tid = np.arange(256)
    warp, lane = tid // 32, tid % 32
    wpg = 8 // g["NGR"]  # warps a group
    unit = lane % g["U"]
    slot = (warp % wpg) * g["SW"] + lane // g["U"]
    rows = np.array([[fwd_row(g["RT"], g["NQ"], q, i) for i in range(g["RT"])] for q in slot])
    return dict(g, group=warp // wpg, unit=unit, slot=slot, rows=rows)


def stage_fwd(whh, U, ng):
    """One direction's W_hh (H, NG H) -> each CTA's shared-memory image of the
    simt forward, (CN, H, NG, U): [c][k][gate][u] = W_hh[k, gate H + c U +
    u], flat index (k NG + gate) U + u."""
    H = whh.shape[0]
    return torch.stack([whh.view(H, ng, H // U, U)[:, :, c] for c in range(H // U)])


@pytest.mark.parametrize("hidden,rt", [(16, 0), (32, 0), (64, 0), (128, 0), (256, 0), (256, 10)])
def test_simt_fwd_maps_cover_each_pair_once(hidden, rt):
    """The forward's 256 threads, in NGR warp groups, cover each group's RG
    rows x U (row, unit) pairs once, one unit's NG gates a thread; a warp's
    lanes hold the U units (a gate's 4-byte W loads U consecutive words of
    the [k][gate][u] slice) by SW row slots, whose 16-byte h loads are SW
    consecutive aligned quads of a k row, and whose one-row loads SW
    consecutive floats: no bank conflict. The groups' rows fill the tile,
    at the default tile and at H = 256's other (80 rows)."""
    m = simt_fwd_maps(hidden, rt)
    U, NQ, RG = m["U"], m["NQ"], m["RG"]
    assert m["R"] == m["NGR"] * RG and U * m["SW"] == 32 and m["NGR"] * NQ * U == 256
    for grp in range(m["NGR"]):
        mine = m["group"] == grp
        cover = np.zeros((RG, U), int)
        np.add.at(cover, (m["rows"][mine], m["unit"][mine][:, None]), 1)
        assert (cover == 1).all()
    for w in range(8):
        lanes = slice(32 * w, 32 * w + 32)
        units, slots, rows = m["unit"][lanes], m["slot"][lanes], m["rows"][lanes]
        assert len(set(m["group"][lanes])) == 1
        assert sorted(set(units)) == list(range(U))
        assert sorted(set(slots)) == list(range(slots.min(), slots.min() + m["SW"]))
        for j in range(m["RT"] // 4):  # 16-byte loads: aligned quads, one a slot
            quads = rows[:, 4 * j]
            assert (quads % 4 == 0).all()
            assert (rows[:, 4 * j:4 * j + 4] - quads[:, None] == np.arange(4)).all()
            assert quads.max() - quads.min() == 4 * (m["SW"] - 1)
        for i in range(m["RT"] // 4 * 4, m["RT"]):  # one row a slot: consecutive floats
            assert rows[:, i].max() - rows[:, i].min() == m["SW"] - 1


@pytest.mark.parametrize("hidden", [16, 32, 64, 128, 256])
def test_simt_fwd_blocks_are_contiguous_and_counted(hidden):
    """CTA c's new h of a group is one contiguous block of the group's
    [k][row] image, k = c U .. (c + 1) U - 1: flat [c U RG, (c + 1) U RG), a
    multiple of 16 bytes (a bulk copy's unit) at a 16-byte aligned offset;
    every thread's stores of its unit's rows land in its CTA's block, and a
    receiver's `full` barrier expects (CN - 1) U RG 4 bytes a phase, the
    blocks of its peers."""
    m = simt_fwd_maps(hidden)
    U, CN, RG = m["U"], m["CN"], m["RG"]
    assert (U * RG * 4) % 16 == 0 and (hidden * RG * 4) % 16 == 0
    for grp in range(m["NGR"]):
        mine = m["group"] == grp
        for c in range(CN):
            flat = (c * U + m["unit"][mine][:, None]) * RG + m["rows"][mine]
            assert flat.min() == c * U * RG and flat.max() == (c + 1) * U * RG - 1
            assert len(np.unique(flat)) == flat.size == U * RG
    assert (CN - 1) * U * RG * 4 == sum(U * RG * 4 for c in range(1, CN))


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


class _Named:
    """A named CTA barrier (bar.sync / bar.arrive) of the given agents: a
    generation completes when each has arrived once; an agent that arrives
    again before that would count toward the wrong turn."""

    def __init__(self, agents):
        self.agents, self.arrived, self.done = set(agents), set(), 0

    def arrive(self, who):
        assert who in self.agents and who not in self.arrived, ("arrived twice", who)
        self.arrived.add(who)
        gen = self.done
        if self.arrived == self.agents:
            self.done, self.arrived = self.done + 1, set()
        return gen


class _Cta:
    """One CTA of the model: each group's h image as block tags (the step
    whose h a block holds; its own block in two parts, its first thread's
    and the others'), its barriers, the steps its agents have read, and its
    first threads' bulk-copy groups."""

    def __init__(self, rank, CN, NGR):
        self.rank = rank
        self.blocks = [[0] * CN for _ in range(NGR)]
        self.own = [[0, 0] for _ in range(NGR)]
        self.full = [_Bar(1) for _ in range(NGR)]
        self.empty = [_Bar(CN - 1) for _ in range(NGR)]
        self.read = [[-1, -1] for _ in range(NGR)]
        self.groups = [[] for _ in range(NGR)]
        agents = [(g, w) for g in range(NGR) for w in (0, 1)]
        # the groups' own barriers, and the turns: group 0's product waits on
        # 3 (group 1's arrival), group 1's on 4 (group 0's)
        self.named = {1 + g: _Named([(g, 0), (g, 1)]) for g in range(NGR)}
        self.named.update({3: _Named(agents), 4: _Named(agents)})


def simt_fwd_protocol(CN, L, seed):
    """The forward's exchange on one cluster, as the kernel runs it, under a
    random interleaving: each of the two warp groups of each CTA is two
    agents (its first thread and the rest, meeting at the group's barriers),
    a step: all wait on the group's `full` (step > 0); the group's turn
    (named barrier 3 + g, which the other group's product passes on; group
    0's first product needs none); the product reads every block of the
    group's image, each of which must hold h(s); the turn passed on (group
    0 always, group 1 while steps remain); the first thread waits until its
    copies have read their source and arms `full` with the bytes to come; a
    group barrier; thread t < CN of the group (not the CTA's rank) arrives
    on peer t's `empty`; both agents write their part of the own block
    (h(s + 1)); a group barrier; the first thread waits on `empty` and
    issues the copies to the peers as one group. A copy reads its source
    some time later (which must still hold the step it was issued for) and
    lands some time after that (the receiver must have read the step
    before: the one-buffer hazard), completing its bytes on the receiver's
    `full`. Every wait checks that its barrier is at the phase waited for
    or one past, and every turn that it is not taken twice. Returns the
    CTAs and the order in which the products ran, or fails on a hazard or a
    deadlock."""
    rng = np.random.RandomState(seed)
    NGR = 2
    ctas = [_Cta(r, CN, NGR) for r in range(CN)]
    copies, products = [], []

    def agent(c, g, who):
        cta = ctas[c]
        me = (g, who)
        for s in range(L):
            more = s + 1 < L
            if CN > 1 and s > 0:
                yield ("wait", cta.full[g], s - 1)
            if g == 1 or s > 0:
                yield ("named", cta.named[3 + g], cta.named[3 + g].arrive(me))
            assert all(tag == s for tag in cta.blocks[g][:c] + cta.blocks[g][c + 1:])
            assert cta.own[g] == [s, s], (c, g, s, cta.own[g])
            cta.read[g][who] = s
            if who == 0:
                products.append((c, s, g))
            if g == 0 or more:
                cta.named[4 - g].arrive(me)
            if who == 0 and CN > 1:
                yield ("wait_read", cta, g)
                if more:
                    cta.full[g].arrive(tx=CN - 1)
            yield ("named", cta.named[1 + g], cta.named[1 + g].arrive(me))
            if CN > 1 and more:
                for p in ([0] if who == 0 else range(1, CN)):
                    if p != c:
                        ctas[p].empty[g].arrive()
            if not more:
                break
            cta.own[g][who] = s + 1
            yield ("named", cta.named[1 + g], cta.named[1 + g].arrive(me))
            if CN > 1 and who == 0:
                yield ("wait", cta.empty[g], s)
                group = [{"src": c, "dst": (c + r) % CN, "g": g, "tag": s + 1,
                          "state": "issued"} for r in range(1, CN)]
                cta.groups[g].append(group)
                copies.extend(group)
        if who == 0 and CN > 1:
            yield ("wait_read", cta, g)

    agents = {(c, g, w): agent(c, g, w) for c in range(CN) for g in range(NGR) for w in (0, 1)}
    at = {k: next(a, None) for k, a in agents.items()}

    def runnable(k):
        op = at[k]
        if op is None:
            return False
        if op[0] == "wait":
            return op[1].passed(op[2])
        if op[0] == "named":
            return op[1].done > op[2]
        return all(cp["state"] != "issued" for grp in op[1].groups[op[2]] for cp in grp)

    while True:
        moves = [("agent", k) for k in agents if runnable(k)]
        moves += [("copy", cp) for cp in copies if cp["state"] != "landed"]
        if not moves:
            break
        kind, obj = moves[rng.randint(len(moves))]
        if kind == "agent":
            at[obj] = next(agents[obj], None)
        elif obj["state"] == "issued":  # the copy reads its source block
            assert ctas[obj["src"]].own[obj["g"]] == [obj["tag"]] * 2, obj
            obj["state"] = "read"
        else:  # and lands in the receiver's image
            dst = ctas[obj["dst"]]
            assert min(dst.read[obj["g"]]) >= obj["tag"] - 1, ("landed on unread h", obj)
            dst.blocks[obj["g"]][obj["src"]] = obj["tag"]
            dst.full[obj["g"]].complete_tx(1)
            obj["state"] = "landed"
    assert all(op is None for op in at.values()), "deadlock"
    return ctas, products


@pytest.mark.parametrize("seed", range(8))
@pytest.mark.parametrize("cn,steps", [(1, 3), (2, 1), (2, 2), (2, 5), (4, 3), (8, 2), (8, 4)])
def test_simt_fwd_exchange_protocol(cn, steps, seed):
    """The forward's `full` / `empty` protocol and the two warp groups'
    turns on one cluster under random interleavings
    (``simt_fwd_protocol``): no deadlock, no block read before
    it holds the step's h, no copy that reads a block overwritten or lands
    on h not yet read, no barrier a phase ahead of its waiter, no turn taken
    twice; each CTA's products run in turn (group 0's step s, group 1's,
    group 0's step s + 1, ...); at the end each `full` and `empty` has
    completed one phase a step but the last."""
    ctas, products = simt_fwd_protocol(cn, steps, seed)
    for c, cta in enumerate(ctas):
        for g in range(2):
            if cn > 1:
                assert cta.full[g].done == cta.empty[g].done == steps - 1
            assert cta.read[g] == [steps - 1, steps - 1]
        mine = [(s, g) for cc, s, g in products if cc == c]
        assert mine == [(s, g) for s in range(steps) for g in range(2)]


def simt_fwd_layer(x, w_ih, b_ih, w_hh, b_hh, compute_dtype=torch.float32, cell="gru", rt=0):
    """The simt forward in the kernel's layout, in plain PyTorch: the
    projection (b_hh folded in but the GRU's b_hn), then per direction, row
    tile (the last padded with zero rows) and step, each warp group in turn
    (its rows of the tile): each CTA c's threads of the group read their
    rows from the group's [k][row] image of h(s) in c and their unit's gates
    of c's staged W_hh slice (``stage_fwd``) into the product (one sum over
    k a (row, unit, gate)); the gate math; out and the residuals stored by
    (row, unit); the new h, rounded to the operand type, into c's block of
    the image, and the block, flat, into every peer's image at the same
    place; RT rows a thread (``rt``, or the default tile's). Returns (out,
    gates) for the GRU, (out, c, gates) for the LSTM, in the store type."""
    from ccsmeth_tpu_torch.ops.kernel_args import op as to_op

    L, N, C = x.shape
    H = w_hh.shape[1]
    ng = 3 if cell == "gru" else 4
    m = simt_fwd_maps(H, rt)
    U, CN, R, RG = m["U"], m["CN"], m["R"], m["RG"]
    dt = compute_dtype

    def op(t):
        return t.to(dt).float()

    tiles = -(-N // R)
    out = torch.zeros((L, tiles * R, 2 * H))
    gates = torch.zeros((2, L, tiles * R, 4 * H))
    cseq = torch.zeros((2, L, tiles * R, H))
    for d in (0, 1):
        fold = b_hh[d].clone()
        if cell == "gru":
            fold[2 * H:] = 0.0
        xg = (x.reshape(L * N, C).float() @ to_op(w_ih[d], dt) + b_ih[d] + fold).view(L, N, -1)
        xg = torch.cat([xg, xg.new_zeros((L, tiles * R - N, ng * H))], dim=1)
        ws = stage_fwd(to_op(w_hh[d], dt), U, ng)
        for r0 in range(0, tiles * R, R):
            imgs = [[torch.zeros(H * RG) for _ in range(CN)] for _ in range(m["NGR"])]
            state = torch.zeros((R, H))
            for s in range(L):
                t = s if d == 0 else L - 1 - s
                for grp in range(m["NGR"]):
                    mine = torch.as_tensor(m["group"] == grp)
                    rows = torch.as_tensor(m["rows"])[mine]                   # (GT, RT)
                    unit = torch.as_tensor(m["unit"])[mine]
                    blocks = []
                    for c in range(CN):
                        hv = imgs[grp][c].view(H, RG)[:, rows]                # (H, GT, RT)
                        w = ws[c][:, :, unit]                                 # (H, NG, GT)
                        acc = torch.einsum("kti,kgt->tig", hv, w)
                        grow = grp * RG + rows                                # tile rows
                        gu = c * U + unit[:, None].expand_as(rows)            # units
                        xv = torch.stack([xg[t, r0 + grow, gate * H + gu] for gate in range(ng)],
                                         dim=-1)
                        sv = state[grow, gu]
                        if cell == "gru":
                            r = torch.sigmoid(xv[..., 0] + acc[..., 0])
                            z = torch.sigmoid(xv[..., 1] + acc[..., 1])
                            hgn = acc[..., 2] + b_hh[d][2 * H + gu]
                            n = torch.tanh(xv[..., 2] + r * hgn)
                            sv = (1.0 - z) * n + z * sv
                            hnew, res = sv, (r, z, n, hgn)
                        else:
                            i_, f_, o_ = (torch.sigmoid(xv[..., k] + acc[..., k]) for k in (0, 1, 3))
                            g_ = torch.tanh(xv[..., 2] + acc[..., 2])
                            sv = f_ * sv + i_ * g_
                            hnew, res = o_ * torch.tanh(sv), (i_, f_, g_, o_)
                            cseq[d, t, r0 + grow, gu] = sv
                        state[grow, gu] = sv
                        out[t, r0 + grow, d * H + gu] = hnew
                        for k, v in enumerate(res):
                            gates[d, t, r0 + grow, k * H + gu] = v
                        blk = imgs[grp][c].clone().view(H, RG)
                        blk[c * U + unit[:, None], rows] = op(hnew)
                        blocks.append(blk.view(-1)[c * U * RG:(c + 1) * U * RG])
                    for c in range(CN):  # the blocks' bulk copies (and the own one)
                        for b in range(CN):
                            imgs[grp][c][b * U * RG:(b + 1) * U * RG] = blocks[b]
    res = (out[:, :N].to(dt), gates[:, :, :N].to(dt))
    return res if cell == "gru" else (res[0], cseq[:, :, :N].to(dt), res[1])


@pytest.mark.parametrize("hidden,rows,dtype,rt", [(16, 131, "float32", 0),
                                                  (16, 131, "bfloat16", 0),
                                                  (64, 70, "float32", 0), (256, 75, "float32", 0),
                                                  (256, 83, "float32", 10)])
def test_simt_fwd_model_equals_plain(hidden, rows, dtype, rt):
    """The forward in the kernel's layout (``simt_fwd_layer``: tiles, warp
    groups, thread map, blocks and their exchange; at H = 256 also the
    80-row tile) against ``bigru_layer_train_fwd_plain`` at a ragged last
    tile: fp32 to 1e-5 (the same products summed in another order); bf16 to
    1e-2 (a stored value one bf16 ulp apart where an f32 sum in another
    order rounds the other way)."""
    dt = getattr(torch, dtype)
    rng = np.random.RandomState(hidden + rows)
    wih, bih, whh, bhh = layer_weights(init_rnn_params(rng, 11, hidden, 1)[0], dt)
    x = torch.from_numpy(rng.randn(3, rows, 11).astype(np.float32)).to(dt)
    got = simt_fwd_layer(x, wih, bih, whh, bhh, dt, rt=rt)
    ref = bigru_vjp.bigru_layer_train_fwd_plain(x, wih, bih, whh, bhh, dt)
    tol = 1e-5 if dt == torch.float32 else 1e-2
    for name, a, r in zip(("out", "gates"), got, ref):
        assert a.dtype == r.dtype and a.shape == r.shape, name
        assert (a.float() - r.float()).abs().max().item() <= tol, name


@pytest.mark.parametrize("hidden", [16, 64])
def test_simt_fwd_model_equals_the_jax_layer(hidden):
    """The model (``simt_fwd_layer``) against the JAX package's
    ``fused_bigru_layer_tm`` forward (``birnn_apply_pallas_trainable``, one
    layer, b_tile 8, interpret mode) on the same numpy weights and inputs:
    tests/test_torch_bigru_vjp.py's forward gate, atol 3e-5 / rtol 1e-5."""
    import jax.numpy as jnp

    from ccsmeth_tpu.ops.bigru_pallas_vjp import birnn_apply_pallas_trainable

    rng = np.random.RandomState(hidden + 11)
    layers = init_rnn_params(rng, 11, hidden, 1)
    x = rng.randn(5, 6, 11).astype(np.float32)  # (N, L, C)
    out_j, _ = birnn_apply_pallas_trainable(layers, jnp.asarray(x), b_tile=8, interpret=True)
    wih, bih, whh, bhh = layer_weights(layers[0])
    out, _gates = simt_fwd_layer(torch.from_numpy(x).transpose(0, 1).contiguous(), wih, bih,
                                 whh, bhh)
    np.testing.assert_allclose(out.transpose(0, 1).numpy(), np.asarray(out_j),
                               atol=3e-5, rtol=1e-5)


def test_simt_fwd_rows_follow_the_occupancy_rule():
    """R at H = 256 is the least multiple of 8 (the 8 row slots) whose
    1,024-row tiles fill the fewest waves of 15 resident clusters of 8 and
    whose CTA fits in shared memory, for both cells: 72 rows, 15 tiles a
    direction, 2 waves (64 rows take 3; no tile that fits the LSTM's CTA, 96
    rows at most, reaches one wave); the source's K46_FWD_RT256 is the
    planner's, and the rows below H = 256 stay the parent's (64; 128 at
    H = 16)."""
    rows, clusters = 1024, 15

    def waves(R):
        return bigru_vjp.rec_waves(R, rows, clusters)

    fits = [R for R in range(8, 257, 8)
            if max(bigru_vjp.k4_smem("simt", 256, 32, R, ng) for ng in (3, 4)) <= SMEM_LIMIT]
    best = min(fits, key=lambda R: (waves(R), R))
    assert best == 72 == bigru_vjp.simt_fwd_geometry(256)["R"]
    assert (waves(72), waves(64), max(fits), waves(max(fits))) == (2, 3, 96, 2)
    for hidden, R in ((16, 128), (32, 64), (64, 64), (128, 64)):
        assert bigru_vjp.simt_fwd_geometry(hidden)["R"] == R
    path = os.path.join(os.path.dirname(bigru_vjp.__file__), "csrc", "rnn_train_rec.cuh")
    with open(path) as f:
        src = f.read()
    assert "#define K46_FWD_RT256 {}\n".format(bigru_vjp.SIMT_FWD_RT256) in src


@pytest.mark.parametrize("rows,tile", [(1024, 72), (1000, 72), (1029, 72), (512, 80),
                                       (504, 72), (505, 80), (560, 80), (561, 72), (100, 72),
                                       (16384, 72)])
def test_simt_fwd_tile_follows_the_rows(rows, tile):
    """The simt forward's tile for a call (``simt_fwd_rows``, 15 clusters of
    8 resident): at H = 256 the planner's 72 rows, or the 80 of one more row
    a thread where that takes less time, waves x rows a tile: the train
    path's 1,024 rows keep 72 (2 waves either way), the 1s families' 512 take
    80 (1 wave; 72 would take 2); the CTA of 80 rows fits for both cells;
    every other H, design and the tc plans keep the plan's one tile, as
    does a plan pinned to one (``fwd_rows`` without the card)."""
    for cell in ("gru", "lstm"):
        plan = bigru_vjp.k45_plan(256, torch.float32, cell)
        assert plan["tiles_fwd"] == (72, 80)
        assert bigru_vjp.simt_fwd_rows(plan, rows, 15) == tile
        assert bigru_vjp.k4_smem("simt", 256, 32, 80, plan["gates"]) <= SMEM_LIMIT
        for R in plan["tiles_fwd"]:
            assert bigru_vjp.fwd_rows(dict(plan, tiles_fwd=(R,)), rows) == R
        for hidden, dt in ((64, torch.float32), (16, torch.bfloat16), (256, torch.bfloat16)):
            other = bigru_vjp.k45_plan(hidden, dt, cell)
            assert other["tiles_fwd"] == (other["rows_fwd"],)
            assert bigru_vjp.simt_fwd_rows(other, rows, 15) == other["rows_fwd"]
            assert bigru_vjp.fwd_rows(other, rows) == other["rows_fwd"]
    waves = [bigru_vjp.rec_waves(r, rows, 15) * r for r in (72, 80)]
    assert tile == (72, 80)[waves[1] < waves[0]]


def test_simt_fwd_model_follows_the_kernel_source():
    """The maps, staging, blocks and protocol of the model above are the
    kernel's: its geometry and warp groups, ``fwd_row``, the thread's group,
    unit and row slot, the [k][gate][u] slice, the product's loads, each
    (row, unit, gate) one fmaf chain over k ascending, the gate math, the own block and its
    copies, the groups' turns, the barriers' counts, arms, arrivals and
    waits, and the shared memory's parts."""
    path = os.path.join(os.path.dirname(bigru_vjp.__file__), "csrc", "rnn_train_rec.cuh")
    with open(path) as f:
        src = " ".join(f.read().split())
    for line in ("static constexpr int U = H < 32 ? H : 32;",
                 "static constexpr int SW = 32 / U;",
                 "static constexpr int NGR = 2;",
                 "static constexpr int NQ = 8 / NGR * SW;",
                 "static constexpr int RT = RT_;",
                 "case 256: return SimtFwdGeom<256, K46_FWD_RT256>::R;",
                 "if (H == 256 && R == SimtFwdGeom<256, K46_FWD_RT256 + 1>::R) return (const void*)"
                 "fwd_rec_simt_kernel<T, LSTM, 256, K46_FWD_RT256 + 1>;",
                 "static constexpr int RG = NQ * RT, R = NGR * RG;",
                 "return i < rt / 4 * 4 ? (i / 4 * nq + q) * 4 + i % 4 : rt / 4 * 4 * nq + "
                 "(i - rt / 4 * 4) * nq + q;",
                 "const int g = warp / (8 / NGR), wg = warp % (8 / NGR);",
                 "const int gtid = tid % GT;",
                 "const int u = lane % U;",
                 "const int q = wg * SW + lane / U;",
                 "const int row0 = (blockIdx.x / CN) * R + g * RG;",
                 "float* hb = hs + g * H * RG;",
                 "const int k = i / (NG * U), gate = i / U % NG, uu = i % U;",
                 "ws[i] = Op<T>::to_f(W[(size_t)k * G + gate * H + u0 + uu]);",
                 "w[gate] = ws[(k * NG + gate) * U + u];",
                 "const float* hk = hb + k * RG;",
                 "*reinterpret_cast<const float4*>(hk + (j * NQ + q) * 4);",
                 "for (int i = RT / 4 * 4; i < RT; ++i) hv[i] = hk[fwd_row(RT, NQ, q, i)];",
                 "for (int k = 0; k < H; ++k) {",
                 "acc[i][gate] = fmaf(hv[i], w[gate], acc[i][gate]);",
                 "const int row = row0 + fwd_row(RT, NQ, q, i);",
                 "sv = fmaf(a[1], sv, a[0] * a[2]);",
                 "hnew[i] = a[3] * tanhf(sv);",
                 "a[2] = tanhf(xc[i][2] + a[0] * a[3]);",
                 "sv = (1.0f - a[1]) * a[2] + a[1] * sv;",
                 "float* blk = hb + unit * RG;",
                 "*reinterpret_cast<float4*>(blk + (j * NQ + q) * 4) =",
                 "blk[fwd_row(RT, NQ, q, i)] = Op<T>::operand(hnew[i]);",
                 "mbar_init(bar0 + 8 * b, 1);",
                 "mbar_init(bar0 + 16 + 8 * b, CN - 1);",
                 "const uint32_t full_bar = bar0 + 8 * g, empty_bar = bar0 + 16 + 8 * g;",
                 "if (CN > 1 && s > 0) mbar_wait(full_bar, (s - 1) & 1);",
                 "if (g == 1 || s > 0) named_sync(3 + g, REC_THREADS);",
                 "if (g == 0 || more) named_arrive(4 - g, REC_THREADS);",
                 "named_sync(1 + g, GT);",
                 "asm volatile(\"cp.async.bulk.wait_group.read 0;\\n\" ::: \"memory\");",
                 "if (more) mbar_expect_tx(full_bar, (CN - 1) * U * RG * 4);",
                 "if (CN > 1 && more && gtid < CN && gtid != (int)crank) "
                 "mbar_arrive_remote(empty_bar, gtid);",
                 "mbar_wait(empty_bar, s & 1);",
                 "const uint32_t src = smem_u32(hb + u0 * RG);",
                 "bulk_to_peer(src, U * RG * 4, full_bar, (crank + r) % CN);",
                 "return (size_t)H * NG * U * 4 + (size_t)H * R * 4 + 32;"):
        assert line in src, line


@pytest.mark.parametrize("marks,parts", [("K46_PROBE_MARKS", "K46_PROBE_PARTS"),
                                         ("K56_PROBE_MARKS", "K56_PROBE_PARTS")])
def test_recurrence_probe_marks_each_apply_once(marks, parts):
    """chip_smoke.py's k46_fwd_simt_probe and k56_bwd_simt_probe build a copy
    of csrc/rnn_train_rec.cuh with clock64 marks put in by text
    replacement: each mark's anchor is in the shipped header exactly once,
    and every part of the step is marked."""
    import importlib.util

    path = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                        "chip_smoke.py")
    spec = importlib.util.spec_from_file_location("chip_smoke_marks", path)
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    with open(os.path.join(os.path.dirname(bigru_vjp.__file__), "csrc",
                           "rnn_train_rec.cuh")) as f:
        src = f.read()
    for old, _new in getattr(smoke, marks):
        assert src.count(old) == 1, old
    marked = "".join(new for _old, new in getattr(smoke, marks))
    tag = marks[:3]
    assert all("{}_PROF({})".format(tag, k) in marked for k in range(len(getattr(smoke, parts))))


# ---- the simt design's fp32 products (csrc/rnn_train_gemm.cuh's
# f32_tma_kernel): which thread owns each element of the dx and weight-
# gradient jobs, and the order of each sum against gemm_simt_kernel's

def gf_thread_map(ak, bk, tn, rm=8):
    """f32_tma_kernel's thread map: thread t of 128, (tx, ty) = (t % 8,
    t / 8), owns rows (rm,) and columns (tn,) of its CTA's 16 rm x 8 tn
    tile: rows ty + 16 i where A is K-major (ak), else 4 ty + i and 64 + 4
    ty + i - 4 (rm = 8); columns tx + 8 j where B is K-major (bk), else 32 (j
    / 4) + 4 tx + j % 4. Returns (rows (128, rm), columns (128, tn), each
    thread's warp)."""
    t = np.arange(128)
    tx, ty = t % 8, t // 8
    i, j = np.arange(rm), np.arange(tn)
    rows = (ty[:, None] + 16 * i if ak else
            np.where(i < 4, 4 * ty[:, None] + i, 64 + 4 * ty[:, None] + i - 4))
    cols = tx[:, None] + 8 * j if bk else 32 * (j // 4) + 4 * tx[:, None] + j % 4
    return rows, cols, t // 32


def gf_dx_tn(C):
    """dx's columns a thread: the least tile of 16, 32, 64 or 128 columns
    that holds C, 8 threads across it."""
    return 2 if C <= 16 else 4 if C <= 32 else 8 if C <= 64 else 16


def gf_owners(M, N, ak, bk, tn, rm=8):
    """How many threads own each element of one (M, N) job, over every CTA
    (bx, by) of the grid, counting only the warps that issue FMAs (a warp
    whose first row, 4 or 16 rows a warp in, lies at or past M issues
    none)."""
    rows, cols, warp = gf_thread_map(ak, bk, tn, rm)
    live_first = (4 if ak else 16) * warp
    count = np.zeros((M, N), np.int64)
    bm = 16 * rm
    for by in range(-(-M // bm)):
        for bx in range(-(-N // (8 * tn))):
            live = bm * by + live_first < M
            m = np.broadcast_to((bm * by + rows)[live][:, :, None], (live.sum(), rm, tn))
            n = np.broadcast_to((8 * tn * bx + cols)[live][:, None, :], (live.sum(), rm, tn))
            ok = (m < M) & (n < N)
            np.add.at(count, (m[ok], n[ok]), 1)
    return count


@pytest.mark.parametrize("rm", [7, 8])
@pytest.mark.parametrize("M,C", [(21 * 13, 11), (300, 21), (300, 28), (1029, 52), (1029, 512)])
def test_f32_dx_owns_every_element_once(M, C, rm):
    """dx (M, C): both operands K-major, the column tile sized by C, 112 or
    128 rows; every element one owner at ragged rows and every layer-0
    width."""
    assert (gf_owners(M, C, True, True, gf_dx_tn(C), rm) == 1).all()


@pytest.mark.parametrize("rows,C,tile", [(21 * 1024, 512, (112, 128)), (21 * 1024, 11, (112, 16)),
                                         (21 * 512, 512, (112, 128)), (21 * 1024, 28, (112, 32)),
                                         (11 * 512, 21, (112, 32)), (128 * 264, 512, (128, 128))])
def test_f32_dx_tile_takes_the_fewest_wave_times(rows, C, tile):
    """dx's tile: at the train path's 1,024 rows and C = 512, 672 tiles of
    128 rows would be 2.55 waves of 264 (three wave-times of 8 rows a
    thread, 24) where 768 of 112 are 2.91 (3 x 7 = 21); where 128-row tiles
    fill whole waves they stay."""
    assert bigru_vjp.simt_dx_tile(rows, C, 132) == tile
    assert tile[1] == 8 * gf_dx_tn(C)


@pytest.mark.parametrize("C,H", [(11, 256), (21, 32), (28, 256), (52, 64), (512, 256), (11, 16)])
def test_f32_weight_grads_own_every_element_once(C, H):
    """Each weight-gradient job of one slice, dW_ih (C, 3H) and dW_hh (H, 3H):
    both operands MN-major, 128 x 128 tiles; every element one owner (and
    a layer-0 dW_ih tile, C = 11, issues FMAs in one warp of four)."""
    G = 3 * H
    for M in (C, H):
        assert (gf_owners(M, G, False, False, 16) == 1).all()
    rows, _c, warp = gf_thread_map(False, False, 16)
    assert sorted(set(warp[(rows < 11).any(axis=1)])) == [0]


def simt_chain(a, b, bk):
    """One (M, N) output as a kernel's threads sum it: acc = fmaf(A[:, k],
    B[k, :], acc) for k ascending from 0.0f over a, b (K, M) and (K, N)
    already zero outside their data, in k tiles of bk (zeros past K)."""
    from tests.test_torch_kernel_layouts import fmaf32

    K, M = a.shape
    N = b.shape[1]
    acc = np.zeros((M, N), np.float32)
    for k in range(-(-K // bk) * bk):
        ak, bk_ = (a[k], b[k]) if k < K else (np.zeros(M, np.float32), np.zeros(N, np.float32))
        acc = fmaf32(ak[:, None], bk_[None, :], acc)
    return acc


def simt_colsum(b, bk):
    """B's column sums as the kernels take them over one slice's rows b (K,
    N): gemm_simt_kernel (bk = 8) lets thread row r of a k tile of 8 add row
    k0 + r into its partial; f32_tma_kernel (bk = FT_KT) adds row k0 + kk
    into partial kk % 8; either way eight plain f32 partials from 0.0f, rows r
    (mod 8) ascending, then added for r = 0 .. 7 from 0.0f."""
    K, N = b.shape
    cs = np.zeros((8, N), np.float32)
    for k0 in range(0, -(-K // bk) * bk, bk):
        for kk in range(bk):
            row = b[k0 + kk] if k0 + kk < K else np.zeros(N, np.float32)
            cs[kk % 8] = (cs[kk % 8] + row).astype(np.float32)
    s = np.zeros(N, np.float32)
    for r in range(8):
        s = (s + cs[r]).astype(np.float32)
    return s


def wgrad_slices(x, out, dxg, dhg, L, N, S, bk):
    """The weight-gradient launch's S slice partials, each as a kernel with
    k tiles of bk sums it: slice s holds rows [s Ks, min(L N, (s + 1) Ks))
    (Ks = slice_rows(L N, S, 32)); dW_ih[d] = X^T dxg[d], dW_hh[d] =
    H_prev^T dhg[d], H_prev of direction 0 out's forward half at row k - N,
    of direction 1 its backward half at k + N, zero outside [N, L N) and
    [0, L N - N) (each direction's first step); db_ih[d], db_hh[d] the
    column sums of dxg[d], dhg[d] (``simt_colsum``), db_hh none where dhg is
    dxg. Returns a list of S dicts of (2, ...) float32 arrays."""
    LN, C = x.shape
    H = out.shape[1] // 2
    Ks = -(-(-(-LN // S)) // 32) * 32
    parts = []
    for s in range(S):
        kb, ke = s * Ks, min(LN, (s + 1) * Ks)
        rows = np.arange(kb, max(kb, ke))
        p = {k: [] for k in ("w_ih", "w_hh", "b_ih", "b_hh")}
        for d in range(2):
            hp = np.zeros((len(rows), H), np.float32)
            src = rows - N if d == 0 else rows + N
            ok = (src >= 0) & (src < LN)
            hp[ok] = out[src[ok], d * H:(d + 1) * H]
            p["w_ih"].append(simt_chain(x[rows], dxg[d][rows], bk))
            p["w_hh"].append(simt_chain(hp, dhg[d][rows], bk))
            p["b_ih"].append(simt_colsum(dxg[d][rows], bk))
            if dhg is not dxg:
                p["b_hh"].append(simt_colsum(dhg[d][rows], bk))
        parts.append({k: np.stack(v) for k, v in p.items() if v})
    return parts


def check_f32_products(L, N, C, H, S, ng, seed):
    """The new kernel's sums (k tiles of FT_KT) against gemm_simt_kernel's (k
    tiles of 8), bit for bit, for dx (two direction segments in one chain)
    and each weight- and bias-gradient slice partial; and their slice sums
    against the exact products, where H_prev's shift and zero rows show."""
    rng = np.random.RandomState(seed)
    LN, G = L * N, ng * H
    x = rng.randn(LN, C).astype(np.float32)
    out = rng.randn(LN, 2 * H).astype(np.float32)
    dxg = rng.randn(2, LN, G).astype(np.float32)
    dhg = dxg if ng == 4 else rng.randn(2, LN, G).astype(np.float32)
    wih = (0.3 * rng.randn(2, C, G)).astype(np.float32)
    # dx: segment 0's k then segment 1's, one accumulator
    a = np.concatenate([dxg[0].T, dxg[1].T])  # (2G, LN): A(m, k) read K-major
    b = np.concatenate([wih[0].T, wih[1].T])  # (2G, C): W_ih[d] read as (c, g)
    from tests.test_torch_kernel_layouts import ft_kt

    assert np.array_equal(simt_chain(a, b, ft_kt()).view(np.uint32),
                          simt_chain(a, b, 8).view(np.uint32))
    new, old = (wgrad_slices(x, out, dxg, dhg, L, N, S, bk) for bk in (ft_kt(), 8))
    for pn, po in zip(new, old):
        assert pn.keys() == po.keys() == ({"w_ih", "w_hh", "b_ih"} | ({"b_hh"} if ng == 3 else set()))
        for k in pn:
            assert np.array_equal(pn[k].view(np.uint32), po[k].view(np.uint32)), k
    total = {k: sum(p[k].astype(np.float64) for p in new) for k in new[0]}
    t = np.arange(LN)
    for d in range(2):
        src = t - N if d == 0 else t + N
        hp = np.where(((src >= 0) & (src < LN))[:, None],
                      out[np.clip(src, 0, LN - 1), d * H:(d + 1) * H], 0.0)
        want = {"w_ih": x.T.astype(np.float64) @ dxg[d], "w_hh": hp.T @ dhg[d],
                "b_ih": dxg[d].sum(0, dtype=np.float64), "b_hh": dhg[d].sum(0, dtype=np.float64)}
        for k in total:
            np.testing.assert_allclose(total[k][d], want[k], rtol=1e-4, atol=1e-3, err_msg=k)


@pytest.mark.parametrize("L,N,C,H,S", [(5, 7, 11, 16, 3), (4, 13, 21, 32, 2), (3, 40, 28, 16, 4),
                                       (6, 9, 52, 16, 1)])
def test_f32_products_sum_as_the_simt_gemm(L, N, C, H, S):
    """GRU (dxg and dhg apart): slice edges inside and past the rows (L N =
    35 in 3 slices of 32: the last one empty, all zeros), ragged k tiles,
    h_prev's -N / +N rows with the first step's zeros, C = 11, 21, 28, 52."""
    check_f32_products(L, N, C, H, S, 3, L * N + C)


def test_f32_products_follow_the_kernel_source():
    """The models above are the kernels': f32_tma_kernel's thread map, k
    tiles, FMA loops, slice rows, segments, column sums and epilogue, dx's
    tile by C and by its waves, the backward's f32 products routed to it;
    and gemm_simt_kernel's column sums, which the new kernel's equal."""
    path = os.path.join(os.path.dirname(bigru_vjp.__file__), "csrc", "rnn_train_gemm.cuh")
    with open(path) as f:
        src = " ".join(f.read().split())
    for line in ("#define FT_BM 128", "#define FT_THREADS 128",
                 "__launch_bounds__(FT_THREADS, 2) f32_tma_kernel(",
                 "static constexpr int BM = 16 * RM, BN = 8 * TN;",
                 "const int tid = threadIdx.x, lane = tid & 31, tx = tid % 8, ty = tid / 8;",
                 "const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;",
                 "if (AK) return ty + 16 * i; return i < 4 ? ty * 4 + i : 64 + ty * 4 + i - 4;",
                 "const int ji = blockIdx.z / p.S, slice = blockIdx.z % p.S;",
                 "const int kb = slice * p.Ks, ke = min(p.K, kb + p.Ks);",
                 "const int KTS = ke > kb ? (ke - kb + KT - 1) / KT : 0;",
                 "const int NT = KTS * p.nseg;",
                 "const int s = q % ST, seg = q / KTS, k0 = kb + (q % KTS) * KT;",
                 "const int z = seg ? o.z1 : o.z0;",
                 "const bool live = m0 + ft_row<AK>(tid / 32 * 4, 0) < M;",
                 "for (int q = 0; q < NT; ++q) {",
                 "const float* ar = as + ty * KT;",
                 "ar + 16 * KT * i + ((c ^ asw) << 2)",
                 "bs + (tx + 8 * j) * KT + ((c ^ bsw) << 2)",
                 "for (int kk = 0; kk < 4; ++kk) #pragma unroll for (int i = 0; i < RM; ++i) "
                 "#pragma unroll for (int j = 0; j < TN; ++j) "
                 "acc[i][j] = fmaf(a[i][kk], b[j][kk], acc[i][j]);",
                 "bs + k * BN + q * 32 + tx * 4",
                 "as + k * FT_BM + 64 * h + ty * 4",
                 "const int k = 4 * c + kk; if (k + 1 < 4 * nc) load(k + 1, aa[(kk + 1) & 1], bb[(kk + 1) & 1]);",
                 "const int nc = PART ? min(KT / 4, (ke - k0 + 3) / 4) : KT / 4;",
                 "if (live) ft_tile<AK, BK, RM, TN, PART ? 0 : KT / 4>(as, bs, tx, ty, acc, nc);",
                 "for (int j = 0; j < 16; ++j) acc[i][j] = fmaf(aa[kk & 1][i], bb[kk & 1][j], acc[i][j]);",
                 "acc[i][j] = 0.0f;",
                 "constexpr bool CS = !AK && !BK;",
                 "const bool do_cs = CS && jb.colsum != nullptr && blockIdx.y == 0;",
                 "for (int kk = 0; kk < KT; ++kk) cs[kk % 8] += bs[kk * BN + tid];",
                 "for (int r = 0; r < 8; ++r) sum += cs[r];",
                 "jb.colsum[so + n0 + tid] = sum;",
                 "const int n = n0 + tx + 8 * j;",
                 "if (m < M) c[(size_t)m * jb.ldc + n] = acc[i][j] + bias;",
                 "const int m = m0 + ft_row<AK>(ty, i);",
                 "const int n = n0 + q * 32 + tx * 4;",
                 "static int dx_cols(int C) { return C <= 16 ? 16 : C <= 32 ? 32 : C <= 64 ? 64 : 128; }",
                 "const long long slots = 2LL * sms;",
                 "const long long tiles = col_tiles * ((M + 16 * rm - 1) / (16 * rm)); "
                 "return (tiles + slots - 1) / slots * rm;",
                 "const int BN = dx_cols(C), RM = ft_rows(M, (C + BN - 1) / BN);",
                 "if (FT_ROWS != 0) return FT_ROWS;",
                 "#define FT_ROWS 0",
                 "return cost(7) < cost(8) ? 7 : 8;",
                 # dx: both directions two segments of one chain, z = the direction
                 "p.job[0] = FtJob{{0, 0, 0, 0, 1}, {0, 0, 0, 0, 1}, M, C, 0, dx, C, nullptr, "
                 "nullptr, 0, nullptr};",
                 "p.nseg = 2;",
                 "if (BN == 16) return ft_launch<true, true, 8, 2, false>(maps, p, grid, s);",
                 "return x_tma ? ft_launch<false, false, 8, 16, false>(maps, p, grid, s) "
                 ": ft_launch<false, false, 8, 16, true>(maps, p, grid, s);",
                 "if (BN == 32) return ft_launch<true, true, 7, 4, false>(maps, p, grid, s);",
                 "if (BN == 64) return ft_launch<true, true, 7, 8, false>(maps, p, grid, s);",
                 "return ft_launch<true, true, 7, 16, false>(maps, p, grid, s);",
                 "return dx_f32_run(dxg, static_cast<const float*>(wih), dx, M, C, G, s);",
                 "return wgrad_f32_run(static_cast<const float*>(x), static_cast<const float*>(out), "
                 "dxg, dhg, part, L, N, C, H, G, S, s);",
                 "p.Ks = slice_rows(LN, S, SLICE_K);",
                 "static_assert(SLICE_K % FT_KT == 0, \"k tiles end at slice ends\");",
                 # h_prev: out's columns d H .., rows k - N (d = 0) or k + N
                 "p.job[2 + d] = FtJob{{1, d * H, d == 0 ? -N : N, 0, 0}, {1, 0, 0, d, d}, H, G, 0,",
                 "one ? nullptr : part + o_bhh + d * G};",
                 # gemm_simt_kernel's column sums (the bf16 simt shapes keep it)
                 "const int b_i = B_KC ? tid / 2 : (tid % 32) * 4, b_k = B_KC ? (tid % 2) * 4 : tid / 32;",
                 "for (int e = 0; e < 4; ++e) cs[e] += rb[e];",
                 "for (int r = 0; r < SG_BK; ++r) s += cs_s[r * GM_BN + tid];"):
        assert line in src, line

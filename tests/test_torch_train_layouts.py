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
    # a K4 thread owns 4 rows x 2 units; a K5 thread the partial of RT rows
    # x 8 units (256 threads: NR row groups x H / 8 unit groups) and the
    # gate math of at most QM quads of 4 units of a row half
    assert (plan["rows_fwd"] // 4) * (U // 2) == 256
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
    (K5) bytes in clusters of 4; simt of 229,376 and 98,304 + 73,728 +
    16,000 + 32 = 188,064 (the W_hh slice, the 8 x 72 x 32 f32 partials
    received, the 40 x 100 operand of a row half, four barriers) in clusters
    of 8."""
    tc = bigru_vjp.k45_plan(256, torch.bfloat16)
    simt = bigru_vjp.k45_plan(256, torch.float32)
    assert (tc["CN"], tc["smem_fwd"], tc["smem_bwd"]) == (4, 168960, 188928)
    assert (simt["CN"], simt["smem_fwd"], simt["smem_bwd"]) == (8, 229376, 188064)
    assert simt["smem_bwd"] == 96 * 256 * 4 + 8 * 72 * 32 * 4 + 40 * 100 * 4 + 32
    assert (simt["rows_fwd"], simt["rows_bwd"]) == (64, 72)


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
        return bigru_vjp.bwd_rec_waves(R, rows, clusters)

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
    threads = {"gemm_simt_kernel": "GM_THREADS", "wgemm_kernel": "WG_THREADS"}[kernel]
    bounds = "__launch_bounds__({}, ".format(threads)
    i = src.index(kernel + "(")
    j = src.rindex(bounds, 0, i)
    return int(src[j + len(bounds):src.index(")", j)])


@pytest.mark.parametrize("cin,kernel,slices", [
    (512, "gemm_simt_kernel", 11), (11, "gemm_simt_kernel", 22),
    (512, "wgemm_kernel", 11), (11, "wgemm_kernel", 22)])
def test_k5_wgrad_slices_fill_whole_waves(cin, kernel, slices):
    """1024 rows, H = 256, 132 SMs: the slices whose tiles fill the last wave
    of blocks, 2 an SM for the weight-gradient kernel of either design (simt:
    gemm_simt_kernel; tc: wgemm_kernel); e.g. 11 x 72 tiles = 3 full waves
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

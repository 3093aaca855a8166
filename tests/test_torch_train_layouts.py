"""K4 and K5's shape rule and K5's staged layout, on the CPU (no card): the
planner ``k45_plan`` that picks each call's design; a model of the K5
recurrence's W_hh staging and reduce-scatter (csrc/rnn_train_rec.cuh, the
recurrences of csrc/bigru_train.cu, stages W_hh in shared memory itself),
held to the kernel source and, through a plain
backward in that layout, to ``bigru_layer_bwd_plain``; and the launch
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
    # a K4 thread owns 4 rows x 2 units, a K5 thread 4 rows x 8 units
    assert (plan["rows_fwd"] // 4) * (U // 2) == 256
    assert (plan["rows_bwd"] // 4) * (hidden // 8) == 256
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
    (K5) bytes in clusters of 4; simt of 229,376 and 180,352 in clusters of 8."""
    tc = bigru_vjp.k45_plan(256, torch.bfloat16)
    simt = bigru_vjp.k45_plan(256, torch.float32)
    assert (tc["CN"], tc["smem_fwd"], tc["smem_bwd"]) == (4, 168960, 188928)
    assert (simt["CN"], simt["smem_fwd"], simt["smem_bwd"]) == (8, 229376, 180352)
    assert (simt["rows_fwd"], simt["rows_bwd"]) == (64, 32)


def test_k45_plan_sends_bf16_h16_to_simt():
    plan = bigru_vjp.k45_plan(16, torch.bfloat16)
    assert plan["design"] == "simt" and plan["why"] == "tc: H % 32 != 0"
    assert (plan["U"], plan["CN"], plan["rows_fwd"], plan["rows_bwd"]) == (16, 1, 128, 512)


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


def own_columns(H, U, c):
    """The W_hh columns of CTA c in K5's recurrence, in staged order: k =
    gate*U + u holds column gate*H + c*U + u."""
    gate = torch.arange(3).view(-1, 1)
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


def _k5_staged(dout, x, w_ih, w_hh, out, gates, compute_dtype, U, design):
    """K5's arithmetic in plain PyTorch, in the kernel's layout: per step, each
    CTA c of the cluster multiplies its own 3U columns of op(dhg) by its
    staged W_hh slice into a partial dh for all H units; the owner of units
    [c'U, (c'+1)U) adds dt z and the CN partials in rank order. dx and the
    weight gradients as single products after the recurrence."""
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
            for c in range(cn):
                a = op(dhg[:, own_columns(H, U, c)])
                dh = dh + (a @ staged[c] if design == "simt" else a @ staged[c].T)
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
                 "const int u0 = crank * U;"):
        assert line in src, line


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

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


@pytest.mark.parametrize("cin,design,slices", [(512, "simt", 11), (11, "simt", 22),
                                               (512, "tc", 11), (11, "tc", 11)])
def test_k5_wgrad_slices_fill_whole_waves(cin, design, slices):
    """1024 rows, H = 256, 132 SMs: the slices whose tiles fill the last wave
    of blocks (simt 2 an SM, tc 1); e.g. 11 x 72 tiles = 3 full waves of 264
    simt blocks, where 4 slices (288 blocks) would leave a second wave of 24."""
    S = bigru_vjp.k5_wgrad_slices(21 * 1024, cin, 256, 132, design)
    assert S == slices
    tiles = 2 * 6 * (-(-cin // 128) + 2)
    slots = (2 if design == "simt" else 1) * 132
    assert (S * tiles) % slots == 0


def test_k5_wgrad_slices_keep_256_rows_a_slice():
    assert bigru_vjp.k5_wgrad_slices(21 * 13, 11, 16, 132, "simt") == 1
    assert bigru_vjp.k5_wgrad_slices(21 * 65, 11, 32, 132, "tc") <= 21 * 65 // 256

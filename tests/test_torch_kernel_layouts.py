"""Layouts and shape rules of the bf16 tensor-core kernels, on the CPU: a
model of K1's gate-interleaved W_hh staging (csrc/birnn_tc.cu stages it in
shared memory itself), held to the kernel source and, through a plain
recurrence in that layout, to models/rnn.py; the planners that pick each
kernel's design; and the launch counters, which a CPU call leaves alone."""

import os

import numpy as np
import pytest
import torch

from ccsmeth_tpu_torch.models.rnn import birnn_tm, init_rnn_params, layer_weights, n_gates
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


@pytest.mark.parametrize("cell", ["gru", "lstm"])
@pytest.mark.parametrize("hidden", [16, 32, 64, 128, 256])
def test_k1_plan_simt_is_the_training_forwards_geometry(hidden, cell):
    """fp32 K1 and K2 run the training forward's simt recurrence, so the
    rule gives k45_plan's U, clusters and forward tile: U = min(H, 32), H / U
    CTAs, 1024 UPT / U rows (UPT = 1 for the LSTM at H = 256)."""
    plan = bigru.k1_plan(hidden, cell, torch.float32)
    k45 = bigru_vjp.k45_plan(hidden, torch.float32, cell)
    assert plan["design"] == k45["design"] == "simt"
    assert (plan["U"], plan["CN"], plan["rows"], plan["smem"]) == (
        k45["U"], k45["CN"], k45["rows_fwd"], k45["smem_fwd"])
    assert plan["U"] == min(hidden, 32) and plan["U"] * plan["CN"] == hidden
    upt = 1 if (cell, hidden) == ("lstm", 256) else 2
    assert plan["rows"] == 1024 * upt // plan["U"] and plan["smem"] <= SMEM_LIMIT


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

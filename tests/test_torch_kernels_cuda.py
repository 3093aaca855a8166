"""Kernels K1 and K2 against their plain PyTorch versions on the card, in
the three designs of the shape rule ``k1_plan``: simt (fp32; K4's projection
and the inference instantiation of the training forward's cluster recurrence,
csrc/birnn_simt.cu), tc (bf16 on the tensor cores, csrc/birnn_tc.cu, also
phase by phase) and l2 (the first f32 kernel, csrc/bigru_stack.cu, for the
shapes neither takes); with bit-equal reruns, K1 = a chain of the training
forwards in fp32, and each call's CUDA launches (K1 = K2 and K2 in its
other designs: tests/test_torch_transenc_kernels_cuda.py). Needs a CUDA
device and skips without one.

This file imports no JAX, so it also runs where JAX is not installed:
    python -m pytest --noconftest -m cuda tests/test_torch_kernels_cuda.py
(tests/conftest.py imports JAX).
"""

import numpy as np
import pytest
import torch

from ccsmeth_tpu_torch.models.rnn import (gru_cell, init_rnn_params, layer_weights,
                                          lstm_cell, n_gates)
from ccsmeth_tpu_torch.ops import bigru, bigru_vjp, bilstm_vjp

# tolerances of chip_smoke.py: fp32 1e-5 (measured 2.7e-7 at full width);
# bf16 1e-2, one bf16 ulp on [0.25, 0.5) plus margin, since an f32 sum taken
# in another order can round an activation the other way
TOL = {"float32": 1e-5, "bfloat16": 1e-2}
RAGGED = (1, 13, 1000, 1029)  # rows: one row, a part tile, 15.6 and 16.1 tiles of 64


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("rows,hidden,layers", [(13, 16, 3), (300, 64, 2),
                                                (1000, 256, 3)])
def test_kernel_matches_plain(dtype, rows, hidden, layers):
    """Odd row counts exercise the ragged last tile; H=64, NL=2 is the golden
    checkpoint's shape, H=256, NL=3 the default model's."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    dt = getattr(torch, dtype)
    rng = np.random.RandomState(rows)
    ly = [layer_weights(ld, dt, "cuda")
          for ld in init_rnn_params(rng, 11, hidden, layers)]
    x = torch.from_numpy(rng.randn(21, rows, 11).astype(np.float32)).to("cuda", dt)
    before = bigru.launches
    out, hn = bigru.birnn_stack(ly, x, dt)
    torch.cuda.synchronize()
    assert bigru.launches == before + 1
    ref_out, ref_hn = bigru.birnn_stack_plain(ly, x, dt)
    assert out.dtype == dt and out.shape == (21, rows, 2 * hidden)
    assert hn.dtype == torch.float32 and hn.shape == (2 * layers, rows, hidden)
    assert (out.float() - ref_out.float()).abs().max().item() <= TOL[dtype]
    assert (hn - ref_hn).abs().max().item() <= TOL[dtype]


@pytest.mark.cuda
def test_kernel_rejects_what_it_cannot_take():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    rng = np.random.RandomState(0)
    ly = [layer_weights(ld, torch.float32, "cuda")
          for ld in init_rnn_params(rng, 11, 18, 1)]  # H % 4 != 0
    x = torch.zeros((21, 4, 11), device="cuda")
    with pytest.raises(ValueError):
        bigru.birnn_stack(ly, x, torch.float32)


def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")


def _stack(rows, hidden, cell, dt, layers=3, seed=0):
    rng = np.random.RandomState(seed + rows + hidden)
    ly = [layer_weights(ld, dt, "cuda")
          for ld in init_rnn_params(rng, 11, hidden, layers, cell)]
    x = torch.from_numpy(rng.randn(21, rows, 11).astype(np.float32)).to("cuda", dt)
    return ly, x


@pytest.mark.cuda
@pytest.mark.parametrize("hidden", [16, 64, 256])
@pytest.mark.parametrize("rows", RAGGED)
def test_tc_design_matches_plain(rows, hidden):
    """The bf16 tensor-core design, GRU cell, three layers, against the plain
    version; a rerun is bit-equal."""
    _need_card()
    cell, dt = "gru", torch.bfloat16
    ly, x = _stack(rows, hidden, cell, dt)
    before = bigru.design_calls["tc"], bigru.launches
    out, hn = bigru.birnn_stack(ly, x, dt, cell)
    out2, hn2 = bigru.birnn_stack(ly, x, dt, cell)
    torch.cuda.synchronize()
    assert (bigru.design_calls["tc"], bigru.launches) == (before[0] + 2, before[1] + 2)
    assert torch.equal(out, out2) and torch.equal(hn, hn2)
    ref_out, ref_hn = bigru.birnn_stack_plain(ly, x, dt, cell)
    assert out.dtype == dt and out.shape == (21, rows, 2 * hidden)
    assert hn.dtype == torch.float32 and hn.shape == (6, rows, hidden)
    assert (out.float() - ref_out.float()).abs().max().item() <= TOL["bfloat16"]
    assert (hn - ref_hn).abs().max().item() <= TOL["bfloat16"]


@pytest.mark.cuda
@pytest.mark.parametrize("cell", ["gru", "lstm"])
@pytest.mark.parametrize("hidden,cin,rows", [(16, 11, 13), (256, 11, 1029),
                                             (256, 512, 1000), (64, 128, 1)])
def test_tc_projection_matches_the_product(cell, hidden, cin, rows):
    """Phase (a) against x W_ih + b in f32: bf16 products are exact in f32,
    so only the order of the f32 sums differs."""
    _need_card()
    rng = np.random.RandomState(hidden + cin)
    wih, bih, _whh, bhh = layer_weights(
        init_rnn_params(rng, cin, hidden, 1, cell)[0], torch.bfloat16, "cuda")
    x = torch.from_numpy(rng.randn(21 * rows, cin).astype(np.float32)).to(
        "cuda", torch.bfloat16)
    before = bigru.cuda_launches
    got = bigru.tc_projection(x, wih, bih, bhh, cell)
    torch.cuda.synchronize()
    assert bigru.cuda_launches == before + 1
    G = n_gates(cell) * hidden
    for d in (0, 1):
        fold = bhh[d].clone()
        if cell == "gru":
            fold[2 * hidden:] = 0.0  # b_hn stays inside the reset product
        ref = x.float() @ wih[d].float() + bih[d] + fold
        assert got[d].shape == (21 * rows, G)
        assert (got[d] - ref).abs().max().item() <= 1e-5 * (1.0 + ref.abs().max().item())


@pytest.mark.cuda
@pytest.mark.parametrize("cell", ["gru", "lstm"])
@pytest.mark.parametrize("hidden,rows", [(16, 13), (64, 1029), (256, 1000), (256, 1)])
def test_tc_recurrence_matches_the_plain_cell(cell, hidden, rows):
    """Phase (b) on given f32 gate inputs against models/rnn.py's cells, the
    h operand rounded to bf16 as the kernel does; tolerance as the stack's."""
    _need_card()
    rng = np.random.RandomState(hidden + rows)
    _wih, _bih, whh, bhh = layer_weights(
        init_rnn_params(rng, 11, hidden, 1, cell)[0], torch.bfloat16, "cuda")
    G, L = n_gates(cell) * hidden, 21
    xg = torch.from_numpy(rng.randn(2, L * rows, G).astype(np.float32)).cuda()
    U = bigru.k1_plan(hidden, cell)["U"]
    before = bigru.cuda_launches
    out, hn = bigru.tc_recurrence(xg, whh, bhh, L, rows, U, cell)
    assert bigru.cuda_launches == before + 1
    torch.cuda.synchronize()
    for d in (0, 1):
        xgd = xg[d].reshape(L, rows, G)
        bias = torch.zeros(G, device="cuda")
        if cell == "gru":
            bias[2 * hidden:] = bhh[d][2 * hidden:]
        h = torch.zeros((rows, hidden), device="cuda")
        c = torch.zeros_like(h)
        for s in range(L):
            t = s if d == 0 else L - 1 - s
            hg = h.to(torch.bfloat16).float() @ whh[d].float() + bias
            if cell == "gru":
                h = gru_cell(xgd[t], hg, h)[0]
            else:
                h, c = lstm_cell(xgd[t] + hg, c)[:2]
            step = out[t, :, d * hidden:(d + 1) * hidden].float()
            assert (step - h).abs().max().item() <= TOL["bfloat16"], (d, s)
        assert (hn[d] - h).abs().max().item() <= TOL["bfloat16"]


@pytest.mark.cuda
@pytest.mark.parametrize("cell", ["gru", "lstm"])
def test_shape_rule_picks_the_design(cell):
    """The model's shape (H = 256, 1024 rows) takes the tensor-core design in
    bf16 and the simt design in fp32; a bf16 H that tc and simt refuse (20)
    takes the l2 kernel and still matches the plain version. A tc or simt
    call is two CUDA launches a layer (projection, recurrence), an l2 call
    one."""
    _need_card()
    for hidden, dt, design in ((256, torch.bfloat16, "tc"), (256, torch.float32, "simt"),
                               (20, torch.bfloat16, "l2")):
        assert bigru.k1_plan(hidden, cell, dt)["design"] == design
        ly, x = _stack(1024 if hidden == 256 else 37, hidden, cell, dt)
        before, cuda_before = dict(bigru.design_calls), bigru.cuda_launches
        out, _hn = bigru.birnn_stack(ly, x, dt, cell)
        torch.cuda.synchronize()
        assert bigru.design_calls[design] == before[design] + 1
        assert bigru.cuda_launches - cuda_before == (1 if design == "l2" else 2 * len(ly))
        for other in set(before) - {design}:
            assert bigru.design_calls[other] == before[other]
        if hidden == 20:
            ref, _ = bigru.birnn_stack_plain(ly, x, dt, cell)
            assert (out.float() - ref.float()).abs().max().item() <= TOL["bfloat16"]


def _k2_counts():
    return (bigru.launches, bigru.cuda_launches, dict(bigru.design_calls),
            bigru.layer_launches, bigru.layer_cuda_launches,
            dict(bigru.layer_design_calls), bigru.layer_plain_calls)


@pytest.mark.cuda
@pytest.mark.parametrize("layers", [1, 3])
@pytest.mark.parametrize("hidden", [16, 32, 64, 256])
@pytest.mark.parametrize("rows", RAGGED)
@pytest.mark.parametrize("cell", ["gru", "lstm"])
def test_simt_design_matches_plain(cell, rows, hidden, layers):
    """K1 in fp32 (the simt design) against the plain version at ragged row
    counts, clusters of 1, 2 and 8 CTAs and 2- and 1-unit threads (the LSTM
    at H = 256): two CUDA launches a layer, and bit-equal on a rerun."""
    _need_card()
    dt = torch.float32
    assert bigru.k1_plan(hidden, cell, dt)["design"] == "simt"
    ly, x = _stack(rows, hidden, cell, dt, layers)
    before, cuda_before = bigru.design_calls["simt"], bigru.cuda_launches
    out, hn = bigru.birnn_stack(ly, x, dt, cell)
    assert bigru.cuda_launches - cuda_before == 2 * layers
    out2, hn2 = bigru.birnn_stack(ly, x, dt, cell)
    torch.cuda.synchronize()
    assert bigru.design_calls["simt"] == before + 2
    assert torch.equal(out, out2) and torch.equal(hn, hn2)
    ref_out, ref_hn = bigru.birnn_stack_plain(ly, x, dt, cell)
    assert out.shape == (21, rows, 2 * hidden) and hn.shape == (2 * layers, rows, hidden)
    assert (out - ref_out).abs().max().item() <= TOL["float32"]
    assert (hn - ref_hn).abs().max().item() <= TOL["float32"]


@pytest.mark.cuda
@pytest.mark.parametrize("hidden,rows", [(16, 13), (64, 1000), (256, 1029)])
@pytest.mark.parametrize("cell", ["gru", "lstm"])
def test_simt_out_is_a_chain_of_training_forwards(cell, hidden, rows):
    """In fp32 K1 runs the training forward's projection and recurrence
    without its residual stores: its out is bit-equal to K4's (GRU) or
    K6's (LSTM) forward applied layer by layer, and its h_n to those
    outputs' last step of each direction."""
    _need_card()
    dt = torch.float32
    ly, x = _stack(rows, hidden, cell, dt)
    out, hn = bigru.birnn_stack(ly, x, dt, cell)
    fwd = (bigru_vjp.bigru_layer_train_fwd if cell == "gru"
           else bilstm_vjp.bilstm_layer_train_fwd)
    inp, h_ns = x, []
    for wih, bih, whh, bhh in ly:
        inp = fwd(inp, wih, bih, whh, bhh, dt)[0]
        h_ns += [inp[-1, :, :hidden], inp[0, :, hidden:]]
    torch.cuda.synchronize()
    assert torch.equal(out, inp)
    assert torch.equal(hn, torch.stack(h_ns))


@pytest.mark.cuda
@pytest.mark.parametrize("cell", ["gru", "lstm"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_k2_h20_takes_l2(dtype, cell):
    """H = 20, which tc and simt refuse, runs K2 on the l2 kernel (one CUDA
    launch) and matches the plain version."""
    _need_card()
    dt = getattr(torch, dtype)
    assert bigru.k1_plan(20, cell, dt)["design"] == "l2"
    rng = np.random.RandomState(20)
    layer = layer_weights(init_rnn_params(rng, 11, 20, 1, cell)[0], dt, "cuda")
    x = torch.from_numpy(rng.randn(21, 37, 11).astype(np.float32)).to("cuda", dt)
    before = _k2_counts()
    out = bigru.bigru_layer_tm(layer, x, dt, cell)
    torch.cuda.synchronize()
    after = _k2_counts()
    assert (after[3] - before[3], after[4] - before[4]) == (1, 1)
    assert after[5]["l2"] - before[5]["l2"] == 1 and after[:3] == before[:3]
    ref = bigru.bigru_layer_tm_plain(layer, x, dt, cell)
    assert (out.float() - ref.float()).abs().max().item() <= TOL[dtype]


@pytest.mark.cuda
@pytest.mark.parametrize("hidden,rows", [(16, 13), (256, 1029)])
@pytest.mark.parametrize("cell", ["gru", "lstm"])
def test_simt_design_in_bf16_matches_plain(cell, hidden, rows):
    """The simt design's bf16 instantiation, which the rule gives the bf16
    shapes that tc refuses and simt takes (none of H = 16 .. 256 today), run
    by hand with the simt geometry against the plain version."""
    _need_card()
    dt = torch.bfloat16
    plan = bigru.k1_plan(hidden, cell, torch.float32)
    ly, x = _stack(rows, hidden, cell, dt)
    out, hn = bigru._stack_layers(ly, x, dt, cell, hidden, plan)
    torch.cuda.synchronize()
    ref_out, ref_hn = bigru.birnn_stack_plain(ly, x, dt, cell)
    assert out.dtype == dt
    assert (out.float() - ref_out.float()).abs().max().item() <= TOL["bfloat16"]
    assert (hn - ref_hn).abs().max().item() <= TOL["bfloat16"]

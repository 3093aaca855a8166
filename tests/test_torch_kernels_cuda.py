"""Kernels K1 and K2 against their plain PyTorch versions on the card, in
the three designs of the shape rule ``k1_plan``: simt (fp32; K4's projection
and csrc/birnn_simt.cu's inference cluster recurrence), tc (bf16 on Hopper's
wgmma, csrc/birnn_tc.cu: the TMA + wgmma projection, the recurrence with and
without layer 0's fused projection, at every instantiated geometry, also
phase by phase) and l2 (the first f32 kernel, csrc/bigru_stack.cu, for the
shapes neither takes); with bit-equal reruns, K1 = a chain of the training forwards in fp32, sha256 digests of
K1's and K2's fp32 outputs taken before the simt recurrence was redesigned,
and each call's CUDA launches (K1 = K2 and K2 in its other designs:
tests/test_torch_transenc_kernels_cuda.py). Needs a CUDA device and skips
without one.

This file imports no JAX, so it also runs where JAX is not installed:
    python -m pytest --noconftest -m cuda tests/test_torch_kernels_cuda.py
(tests/conftest.py imports JAX).
"""

import hashlib

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


def _tc_launches(hidden, cell, widths):
    """CUDA launches of a tc call over layers of these input widths (two a
    layer, one where the projection fuses) and its projections by kernel."""
    plan = bigru.k1_plan(hidden, cell)
    fused = [bool(bigru.tc_fused_kx(plan, c, cell, hidden)) for c in widths]
    proj = {"wgmma": sum(1 for c, f in zip(widths, fused) if not f and c % 8 == 0),
            "mma": sum(1 for c, f in zip(widths, fused) if not f and c % 8)}
    return sum(1 if f else 2 for f in fused), proj


@pytest.mark.cuda
@pytest.mark.parametrize("layers", [1, 3])
@pytest.mark.parametrize("cell", ["gru", "lstm"])
@pytest.mark.parametrize("hidden", [16, 32, 64, 128, 256])
@pytest.mark.parametrize("rows", RAGGED)
def test_tc_design_matches_plain(rows, hidden, cell, layers):
    """The bf16 tensor-core design against the plain version, layer 0 (C =
    11) with its projection fused; a rerun is bit-equal; one call's design,
    CUDA launches and projections by kernel."""
    _need_card()
    dt = torch.bfloat16
    ly, x = _stack(rows, hidden, cell, dt, layers)
    want, proj = _tc_launches(hidden, cell, [11] + [2 * hidden] * (layers - 1))
    before = bigru.design_calls["tc"], bigru.launches, dict(bigru.tc_projection_calls)
    bigru.cuda_launches = 0
    out, hn = bigru.birnn_stack(ly, x, dt, cell)
    assert bigru.cuda_launches == want
    assert {k: bigru.tc_projection_calls[k] - before[2][k] for k in proj} == proj
    out2, hn2 = bigru.birnn_stack(ly, x, dt, cell)
    torch.cuda.synchronize()
    assert (bigru.design_calls["tc"], bigru.launches) == (before[0] + 2, before[1] + 2)
    assert torch.equal(out, out2) and torch.equal(hn, hn2)
    ref_out, ref_hn = bigru.birnn_stack_plain(ly, x, dt, cell)
    assert out.dtype == dt and out.shape == (21, rows, 2 * hidden)
    assert hn.dtype == torch.float32 and hn.shape == (2 * layers, rows, hidden)
    assert (out.float() - ref_out.float()).abs().max().item() <= TOL["bfloat16"]
    assert (hn - ref_hn).abs().max().item() <= TOL["bfloat16"]


@pytest.mark.cuda
@pytest.mark.parametrize("layers", [1, 3])
@pytest.mark.parametrize("cell", ["gru", "lstm"])
@pytest.mark.parametrize("hidden,rows", [(16, 13), (64, 1000), (256, 1029), (256, 1)])
def test_tc_layers_match_plain(cell, hidden, rows, layers):
    """K2 in the tc design, one layer a call (layer 0's projection fused: one
    CUDA launch; the others two), against the plain version; a rerun is
    bit-equal and K1 launches nothing."""
    _need_card()
    dt = torch.bfloat16
    ly, x = _stack(rows, hidden, cell, dt, layers)
    want = _tc_launches(hidden, cell, [11] + [2 * hidden] * (layers - 1))[0]
    k1 = (bigru.launches, bigru.cuda_launches)
    bigru.layer_cuda_launches = 0
    out, hn = bigru.birnn_layers(ly, x, dt, cell)
    assert bigru.layer_cuda_launches == want and (bigru.launches, bigru.cuda_launches) == k1
    out2, _hn2 = bigru.birnn_layers(ly, x, dt, cell)
    torch.cuda.synchronize()
    assert torch.equal(out, out2)
    ref_out, _ref_hn = bigru.birnn_stack_plain(ly, x, dt, cell)
    assert (out.float() - ref_out.float()).abs().max().item() <= TOL["bfloat16"]


@pytest.mark.cuda
@pytest.mark.parametrize("cell,geometry", [("gru", (64, 2, 2)), ("gru", (64, 1, 2)),
                                           ("gru", (128, 1, 4)), ("lstm", (64, 2, 2)),
                                           ("lstm", (64, 1, 2))])
@pytest.mark.parametrize("rows", RAGGED)
def test_tc_geometries_match_plain(rows, cell, geometry):
    """Every instantiated geometry of the bf16 recurrence at H = 256 (the
    candidates of chip_smoke.py's k1_tc_sweep), the whole stack (layer 0
    fused where the geometry fuses it, else the mma.sync projection at C =
    11) against the plain version, bit-equal on a rerun."""
    _need_card()
    dt = torch.bfloat16
    plan = dict(bigru.tc_geometry(256, cell, geometry), design="tc")
    ly, x = _stack(rows, 256, cell, dt)
    out, hn = bigru._stack_layers(ly, x, dt, cell, 256, plan)
    out2, hn2 = bigru._stack_layers(ly, x, dt, cell, 256, plan)
    torch.cuda.synchronize()
    assert torch.equal(out, out2) and torch.equal(hn, hn2)
    ref_out, ref_hn = bigru.birnn_stack_plain(ly, x, dt, cell)
    assert (out.float() - ref_out.float()).abs().max().item() <= TOL["bfloat16"]
    assert (hn - ref_hn).abs().max().item() <= TOL["bfloat16"]


PROJ_CASES = ([(256, cin, rows) for cin in (11, 28, 52, 512)
               for rows in (1, 13, 1000, 1029, 16384)]
              + [(16, 11, 13), (64, 128, 1), (32, 21, 1000)])


@pytest.mark.cuda
@pytest.mark.parametrize("cell", ["gru", "lstm"])
@pytest.mark.parametrize("hidden,cin,rows", PROJ_CASES)
def test_tc_projection_matches_the_product(cell, hidden, cin, rows):
    """Phase (a) against x W_ih + b in f32: bf16 products are exact in f32,
    so only the order of the f32 sums differs. C % 8 == 0 runs the TMA +
    wgmma GEMM, other widths the mma.sync one."""
    _need_card()
    torch.backends.cuda.matmul.allow_tf32 = False  # the reference's products
    rng = np.random.RandomState(hidden + cin)
    wih, bih, _whh, bhh = layer_weights(
        init_rnn_params(rng, cin, hidden, 1, cell)[0], torch.bfloat16, "cuda")
    x = torch.from_numpy(rng.randn(21 * rows, cin).astype(np.float32)).to(
        "cuda", torch.bfloat16)
    kernel = "wgmma" if cin % 8 == 0 else "mma"
    before, calls = bigru.cuda_launches, bigru.tc_projection_calls[kernel]
    got = bigru.tc_projection(x, wih, bih, bhh, cell)
    torch.cuda.synchronize()
    assert bigru.cuda_launches == before + 1
    assert bigru.tc_projection_calls[kernel] == calls + 1
    G = n_gates(cell) * hidden
    for d in (0, 1):
        fold = bhh[d].clone()
        if cell == "gru":
            fold[2 * hidden:] = 0.0  # b_hn stays inside the reset product
        ref = x.float() @ wih[d].float() + bih[d] + fold
        assert got[d].shape == (21 * rows, G)
        assert (got[d] - ref).abs().max().item() <= 1e-5 * (1.0 + ref.abs().max().item())


@pytest.mark.cuda
@pytest.mark.parametrize("fused", [False, True])
@pytest.mark.parametrize("cell", ["gru", "lstm"])
@pytest.mark.parametrize("hidden", [16, 32, 64, 128, 256])
@pytest.mark.parametrize("rows", RAGGED)
def test_tc_recurrence_matches_the_plain_cell(rows, hidden, cell, fused):
    """Phase (b) on given f32 gate inputs, or (``fused``) on x (L, N, 11)
    with the projection inside the kernel, against models/rnn.py's cells
    step by step, the h operand rounded to bf16 as the kernel does;
    tolerance as the stack's."""
    _need_card()
    torch.backends.cuda.matmul.allow_tf32 = False
    rng = np.random.RandomState(hidden + rows)
    wih, bih, whh, bhh = layer_weights(
        init_rnn_params(rng, 11, hidden, 1, cell)[0], torch.bfloat16, "cuda")
    G, L = n_gates(cell) * hidden, 21
    plan = bigru.k1_plan(hidden, cell)
    before = bigru.cuda_launches
    if fused:
        x = torch.from_numpy(rng.randn(L, rows, 11).astype(np.float32)).to(
            "cuda", torch.bfloat16)
        out, hn = bigru.tc_recurrence(None, whh, bhh, L, rows, plan, cell,
                                      fused=(x, wih, bih))
        xg = torch.empty((2, L * rows, G), device="cuda")
        for d in (0, 1):
            fold = bhh[d].clone()
            if cell == "gru":
                fold[2 * hidden:] = 0.0
            xg[d] = x.view(L * rows, 11).float() @ wih[d].float() + bih[d] + fold
    else:
        xg = torch.from_numpy(rng.randn(2, L * rows, G).astype(np.float32)).cuda()
        out, hn = bigru.tc_recurrence(xg, whh, bhh, L, rows, plan, cell)
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
    takes the l2 kernel and still matches the plain version. A simt call is
    two CUDA launches a layer (projection, recurrence), a tc call one less
    (layer 0's projection fused), an l2 call one."""
    _need_card()
    for hidden, dt, design in ((256, torch.bfloat16, "tc"), (256, torch.float32, "simt"),
                               (20, torch.bfloat16, "l2")):
        assert bigru.k1_plan(hidden, cell, dt)["design"] == design
        ly, x = _stack(1024 if hidden == 256 else 37, hidden, cell, dt)
        before, cuda_before = dict(bigru.design_calls), bigru.cuda_launches
        out, _hn = bigru.birnn_stack(ly, x, dt, cell)
        torch.cuda.synchronize()
        assert bigru.design_calls[design] == before[design] + 1
        want = {"l2": 1, "simt": 2 * len(ly), "tc": 2 * len(ly) - 1}[design]
        assert bigru.cuda_launches - cuda_before == want
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
    counts, clusters of 1, 2, 4 (the GRU at H = 256) and 8 (the LSTM at H =
    256) CTAs, with one h buffer and two: two CUDA launches a layer, and
    bit-equal on a rerun."""
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


# the cases of the digests below: cell, H, rows, layers, C
K1_DIGEST_CASES = [(cell, hidden, rows, layers, cin) for cell in ("gru", "lstm")
                   for hidden in (16, 32, 64, 256) for rows in RAGGED
                   for layers in (1, 3) for cin in (11, 512)]

# sha256 of ``k1_digest(*case)``, taken on an H100 from the kernels as they
# were before the fp32 simt design got its own inference recurrence (the
# training forward's recurrence after K4's projection, as K1 and K2 ran
# them then): the redesign leaves every bit of K1's and K2's fp32 outputs
# as it was.
K1_DIGESTS = {
    ('gru', 16, 1, 1, 11): "c0eb54cbf68dab041136a86199b6bdad4ecde53ca657cf2b6b5742461c1ffd9a",
    ('gru', 16, 1, 1, 512): "a1d65971835c7e3a8339e7285b877f3091236fe9312b5ebefbb2d9369bbe64d0",
    ('gru', 16, 1, 3, 11): "bec1588d6fd8b059793310281e4a9625eb1fcd1ba1a9058100e2ff20937e6bec",
    ('gru', 16, 1, 3, 512): "1475d1a305b38914108cad939c0670855049cd2f4a2a2944c3ca124d456cbbb7",
    ('gru', 16, 13, 1, 11): "5efeab1059851219ebb3f82d0c3f342fd0287f485e2761b2c6d560ee9e42695e",
    ('gru', 16, 13, 1, 512): "33441ec7b91a244ffcd118fe9c9a770aa482898a2bace349e2e8eab97ff42e7a",
    ('gru', 16, 13, 3, 11): "17606884de7f75a6b6f08edec84396d75e5160c5fcda85cee14775fce3c0373f",
    ('gru', 16, 13, 3, 512): "f1f5b36c91792d6738691f4d9a971b56d295d158132a347d180f495df695b7ad",
    ('gru', 16, 1000, 1, 11): "a6046fe51fdbd168fe9c2b11d792d33953aa2435abf3f3cfa3b3c1c038ed4f28",
    ('gru', 16, 1000, 1, 512): "a7b0030607adb0d7ea1388f7604c19261187650bf7bcd2b953d3b394f3ff827a",
    ('gru', 16, 1000, 3, 11): "bab1e6dc724c8a7e6437ddf351414b71a332956cca00624cdf5abb3302b16dcf",
    ('gru', 16, 1000, 3, 512): "6bfe35c136446cd0dadce457a3f1bb2b61c78c95d368fdd35cceca325004a083",
    ('gru', 16, 1029, 1, 11): "24ae12a0811dfb72fc47be69c719a3d45948111a72dfdce8ca3f474aaf95f85f",
    ('gru', 16, 1029, 1, 512): "7fafa85d5316326a849ca4c280c8285b9269093f3e31db05b3e2ca3e24d91d9b",
    ('gru', 16, 1029, 3, 11): "0122378f21837c649c31263134689bb6672719fbe415cb63bcc771968463fe3f",
    ('gru', 16, 1029, 3, 512): "56308faa7643e1d1f6d55d5aff7ebdb6477f57daa6520920b8c8f0064877bcd9",
    ('gru', 32, 1, 1, 11): "863a3af8e866434645963e36f7553edde840296b9251bd393a8abd1ca8d2d52d",
    ('gru', 32, 1, 1, 512): "059624974050df358135f06505c604fe19e319529709e3ae96631d38c4657828",
    ('gru', 32, 1, 3, 11): "98e6c9436fdab1f2cb4d744bd3938a8db90ba5745713fa5ec75de4b49145447f",
    ('gru', 32, 1, 3, 512): "4a247d1372f195335de3db8908e38303fb714c33353f41f782e93ac1769dd3cd",
    ('gru', 32, 13, 1, 11): "a11bdbbcb2fb0dfff8b111c736eb8bd952940c0407a5891fe489d499adfc84b2",
    ('gru', 32, 13, 1, 512): "2e9920e92924a42aaf119a49c7c1ea5f2e6f7094aaa9bc75a3e079404cc5fe84",
    ('gru', 32, 13, 3, 11): "05e39d294565f1954838e1d107a2a13475c7d2c7a9bd8ac06b79d6cefc0d5d84",
    ('gru', 32, 13, 3, 512): "1908121fc96c88862190b988c0b482de435a07eebb166ba4e98c8948299de225",
    ('gru', 32, 1000, 1, 11): "7033bec00de64239423d69f8c3fab33f63363002d69cca720fe1844056c1b6c6",
    ('gru', 32, 1000, 1, 512): "55943600d9a60a479542cced1db0a693af464a2e05f359bbba831f74aa8a406c",
    ('gru', 32, 1000, 3, 11): "e68a8b4286ec41378ef19ee6bea48f04c016305fae7f99fbc4eb329e4ecde433",
    ('gru', 32, 1000, 3, 512): "81dcc556d0f75de54066cfcd3d6bd00b44dc8747ca86e2ae82689cfb66549b00",
    ('gru', 32, 1029, 1, 11): "b95bcc554146f1122c6718663253009413ea7e99be9a9f878ea59d26b38f2482",
    ('gru', 32, 1029, 1, 512): "53ef912caafbd4ae4c5a5bf0903081803e98545402a46d16ba30e8a4e1b5a9be",
    ('gru', 32, 1029, 3, 11): "dd731d0b0eb458de60b7e5a3db839d96ab42c0488af192a268ba3d5d21b7cfad",
    ('gru', 32, 1029, 3, 512): "29de0e00fd2893cc2158df99f921a6d7e9e9de8a99d06e149d73ea1b380489bd",
    ('gru', 64, 1, 1, 11): "1f04ac9553086062f5b6c9de8b08842017eb0b3ee563ac4d1bc64ad0a8262da7",
    ('gru', 64, 1, 1, 512): "4ab455be9db9be7aa5ca6b239852e37bd3da2398b178a8a3aec6982a7a6d6dd9",
    ('gru', 64, 1, 3, 11): "dbe9c923c5791379ae1c9bdc53defca9972bbc48f4a4ed5e028cb894f183d60e",
    ('gru', 64, 1, 3, 512): "da536cb8f0deb13f277ec7434019891ac65edf24bd3e50c1ce7c423373dbf981",
    ('gru', 64, 13, 1, 11): "184eddfe31e6ea9e614d73dd13ad29c1fced6a1116e29564f6d5bd4530a41359",
    ('gru', 64, 13, 1, 512): "19eff902484e55bf70ebae0ae09f515b20b0a4fd1ad7a0beb2678ab382eb2b87",
    ('gru', 64, 13, 3, 11): "b488719c064c0caa264be21a750e3bd7f99c56776f78cfdfa212a4890c8745c3",
    ('gru', 64, 13, 3, 512): "f658d9a6bcf8c7b0dfe25cbd84bddb09a2247e4c43c1d7db4993e372b60c444b",
    ('gru', 64, 1000, 1, 11): "dd84b42185a066d502df4716984da917d8d4f1920ad580fc910a39e1d860ea2a",
    ('gru', 64, 1000, 1, 512): "8fe9fe59caf958af6061cac69c5bc9f42cc0d8befa68be0f0b84ac1526f8aecd",
    ('gru', 64, 1000, 3, 11): "edf994add3e709f53c67535cdff325eaff58a237afc0ef91592c5689d51f6c13",
    ('gru', 64, 1000, 3, 512): "b8b4777b87d00043be72b0a00d0581ef1ccce24cbf3a85a642912464ff3502c4",
    ('gru', 64, 1029, 1, 11): "f8a40b318eca701867e5d6484a117cfd7c96b760488097e2c8908d5fbd2869c7",
    ('gru', 64, 1029, 1, 512): "3c760a5cd46dea91cc3a5bde36e2e30ed4b3c8bd3aaba755a70ba1838fa6f301",
    ('gru', 64, 1029, 3, 11): "d3c1383a894243b175750f0de7f1fea61f2209db1ce77a9673e98f9d933b4a9c",
    ('gru', 64, 1029, 3, 512): "0b38aa54f5bd84ecf3c6ab619ef2becdef5ac8ec36581428d090341c64d362b9",
    ('gru', 256, 1, 1, 11): "49b574a8b37e76004113f29c854339b49508d3a6aad5800e3706f9bdb750ae62",
    ('gru', 256, 1, 1, 512): "cbc762b2497638cb08a123c9012bce285a37861aa4f36e93ea17380d8a1b8228",
    ('gru', 256, 1, 3, 11): "4f56bc13fd793929cff4676d0db2616c20e1cf35cfbc9e85cada17aff151a82d",
    ('gru', 256, 1, 3, 512): "ff012c95534dc084df4f1b020e8c9ff85f8e5bb74de79ab9e184d37960479a43",
    ('gru', 256, 13, 1, 11): "09ae4105845ca1f9ac16026840838f274cd451c6ff75b1586fb2cf2309fc2edc",
    ('gru', 256, 13, 1, 512): "cf238e02a59bf4861126614720e21127364e16c5f0f45eb8a710d716c19e8740",
    ('gru', 256, 13, 3, 11): "3e7c8b073f2a80b10a00a4633af4313e1223aa01553661b45055ebf7b99d6009",
    ('gru', 256, 13, 3, 512): "d40390cbdda0d1f67a40c48e6bb5cb741c92763cd57e1cdaec33fb54c1caca8b",
    ('gru', 256, 1000, 1, 11): "bfc9f6f9c06db4f2bf003e482c627f35703fe1df908af6f47f466ea5620cb4d9",
    ('gru', 256, 1000, 1, 512): "580552feb9abc8dc74d862ce3a775c34b8dc770a2e669cecd871def5a3570e7c",
    ('gru', 256, 1000, 3, 11): "f507454f91356b10ed96180b1cbcd00489b8d439b0d27dace836dee367fef5c2",
    ('gru', 256, 1000, 3, 512): "eec00e68b49d7dfd100d362c0358d98a1c03b10116d5509cb6240f2b62df68b6",
    ('gru', 256, 1029, 1, 11): "f65bacc8961370a71e3a0300cae96b3e0a301b3ecc6d2c19e30afb277788968a",
    ('gru', 256, 1029, 1, 512): "2f8673f6d3c17f2f48208d40b7a0b7743dae66ce3201a8bed3fffd2bcb332afb",
    ('gru', 256, 1029, 3, 11): "1039936b386604af7bf6dac7c1a58d16d64c745dc37afb61472665d8477722c2",
    ('gru', 256, 1029, 3, 512): "39e16fc686f833a9df24b6388a1b535343c41f642f3e850daa50205ed49c2b78",
    ('lstm', 16, 1, 1, 11): "4cc1c8a84d8614106931b9699fbee0578aa34529cf1d82be0a305c3f8fe886a7",
    ('lstm', 16, 1, 1, 512): "d06c53e4e474cf43f23ad60abbf3a86f101de13bb50508c53aa385adff675211",
    ('lstm', 16, 1, 3, 11): "319e5af568a722a3cf52d44a9cee5d8ae001498873a6b6934b6c335c62f32f26",
    ('lstm', 16, 1, 3, 512): "008255073517b57b2ea7762f8b619229ad1eb3794c45e4e301b13342ab175744",
    ('lstm', 16, 13, 1, 11): "e287cced418cc59fdea125a936b896b0d1443035e76d8b8a513451c2edcf41b0",
    ('lstm', 16, 13, 1, 512): "b1fc2a4f849a5b320fe86abbc80364280ab9e581f8ff7bfcb399ccb0c6908ae7",
    ('lstm', 16, 13, 3, 11): "2645badea74da877123150d247edf62ecf86701607b909185ce710d1bfa91cd3",
    ('lstm', 16, 13, 3, 512): "6f57ab4e1b954456c36795c03db6d564342f55bebe3b9e934cf3c37659bf8e89",
    ('lstm', 16, 1000, 1, 11): "8c9ac800d718885efde5b55a863e1b329e6ec911550828eb46871b50e2a2dc13",
    ('lstm', 16, 1000, 1, 512): "625a0027937d2bc07008aa85ff3787e4e15ad38202a633c110e140fc30cfef75",
    ('lstm', 16, 1000, 3, 11): "f71f61824a7479c442c0cd90e12e72d6e3b6407161d7f3a34a9d5f24e9123ec3",
    ('lstm', 16, 1000, 3, 512): "480e2b603191d322b703737bc40af0ed9cfd5ccea6e609b531b3d710a3299bba",
    ('lstm', 16, 1029, 1, 11): "b5275d2524cc4c4b3c51e303ccca969384e3cafa93f80d2b77ae3c82c6121ed6",
    ('lstm', 16, 1029, 1, 512): "6144a9f26d4001123e5f8bf990dc40eddc6435fd366ffa0da8dea02e3ffc7384",
    ('lstm', 16, 1029, 3, 11): "96db913dc8378916aa464c9e3f7776da1616686c8ce7cdcac4b8e970b24f6002",
    ('lstm', 16, 1029, 3, 512): "350bf760c5a576a021317de50089f4b23fa643b6f147f7cf1f172be91a8cf629",
    ('lstm', 32, 1, 1, 11): "24f05891cb7fb0772998ac252a85dd79abf06aaded2a503b88e7daa4756b6cb7",
    ('lstm', 32, 1, 1, 512): "99f42c3652d8c7f1adf0c2936ecddf09c1767c54b999b6be8e2a4692cfbcf721",
    ('lstm', 32, 1, 3, 11): "80b373b0a143192b5cb756ca469714f1d032cf3a3f6c237076828fd285047526",
    ('lstm', 32, 1, 3, 512): "3238ef849423b12a0d54d135bfaa0e73ec8d3585328d97d490b0584e50fa1ed2",
    ('lstm', 32, 13, 1, 11): "f68ffbd3d89563ea0972f43dfde9f123133c737d00f3bfb47520ecbbe4a8ffed",
    ('lstm', 32, 13, 1, 512): "1166dd4e97f480f9f32e9ee6914d8b8369d1ad953accb4d8e69a4ed8a6b46db4",
    ('lstm', 32, 13, 3, 11): "3754aa82e0a4dafe82226c11aabce1987c826ef8c2ba1668cca47eed1c5a486f",
    ('lstm', 32, 13, 3, 512): "cfd1b720476124f29f8a2679147572a7bd6716fc876221d7690f7e7877a6e2e0",
    ('lstm', 32, 1000, 1, 11): "ea8f473b39f57d81f148e0f95f54eff27ec366f357cef4dce878882a0ba2d31a",
    ('lstm', 32, 1000, 1, 512): "1057a34acc08ff8d1975de4d3a473c4ea6b7c496007f2b4c3ab863df0330c476",
    ('lstm', 32, 1000, 3, 11): "cf25ca7d7204c995b566776c66ec1cf8e2085c8b84d3d7eeae2ba2db867b3128",
    ('lstm', 32, 1000, 3, 512): "02d0728c28f323016cf30cb086e8cc74bf5cdce5e72ec85a1e2aaec99ee47c51",
    ('lstm', 32, 1029, 1, 11): "150accbe9ac770a022907057168c7381a45cf6124ff4e72393815961f126d5db",
    ('lstm', 32, 1029, 1, 512): "319cc63b34acf134deed500fabaf9579c66c09f0b8a42a90f053f90cfdc86f19",
    ('lstm', 32, 1029, 3, 11): "5f09e6f5ddf5eb46136fe06353fa90ca27045ad62d134bc751877f7eac51b2e8",
    ('lstm', 32, 1029, 3, 512): "77e9c2c7290c31e606d8abcf6448ec13f3c61f22a5de60e9aabf876aaf35ddc4",
    ('lstm', 64, 1, 1, 11): "ef855dbbd36928ff96b94b90c230018754cc19a58f8cac3b0d796492b4fedc35",
    ('lstm', 64, 1, 1, 512): "76a3acdf789eb1cea76eb6f011c06074bf6df86158417d3ac5c8215297bbbcfd",
    ('lstm', 64, 1, 3, 11): "0e1efee4ec624afd68d94d6308c3135c5389a81db43ceaa06eb6d73d4ae92e11",
    ('lstm', 64, 1, 3, 512): "1d11b9c3baf6f8f6f5256742a14e60182fb4825de8a589b42ffed1a65d52bcd2",
    ('lstm', 64, 13, 1, 11): "0335c1cad4e6258247cd844e39bc81148ae2ad354736e44d96da80b1cc4f7c32",
    ('lstm', 64, 13, 1, 512): "bd9aec62c9bd122cf3f2164fd90cdc2dd76ca5c62dbaf763c76eeac2e7f952af",
    ('lstm', 64, 13, 3, 11): "cd224dd9131133a4bc2bafa94198ba93775e21018911f45136d31f74591ae8a2",
    ('lstm', 64, 13, 3, 512): "0c89e74a76bc1912150d77224a345fa42c2305c15efcd5ff5a8581fa17dbb2a9",
    ('lstm', 64, 1000, 1, 11): "a8a066353b120b02316e1a76ecb9c44d6b3f9b38afb2649d3f5e7b815301cfb7",
    ('lstm', 64, 1000, 1, 512): "d91ab4c1f2a8fce812ec7cbaee05764783be2f1ce6d9b59debf97f722f871c68",
    ('lstm', 64, 1000, 3, 11): "6bab28fb6962c23d75953779984128eedb532575420b4a1565027a7ef4d2856e",
    ('lstm', 64, 1000, 3, 512): "8d8dc7bd87acd518096e88e6bd6e5ed217b4d05cda72784ab62631c1c3f953d2",
    ('lstm', 64, 1029, 1, 11): "b4a1ab6dd32a5b6ab672824d9886d314d0150b450ae43479532f797116fcea13",
    ('lstm', 64, 1029, 1, 512): "18ce1283a9fea9126746e648d96adfa4b8b2e171abd26d5c30679abaf7d79ca7",
    ('lstm', 64, 1029, 3, 11): "c9bb5f646a49eedbfca651152b73fbeb0e96e95fae17a9c0a270ed79d63bf7d4",
    ('lstm', 64, 1029, 3, 512): "0c0c92dcf58e47dbbfd9a7025f424cbe3b0d5ee8ff30ddd0823efabbe20905ac",
    ('lstm', 256, 1, 1, 11): "bf1a90fcb28f9447a1fc657a6972f5d8200dbb9a2591969b2279f2a8f736db2b",
    ('lstm', 256, 1, 1, 512): "55b465e48e6ce15db6ed9108985e60d9ed1fc4c8c2cfa54e99206b521523705c",
    ('lstm', 256, 1, 3, 11): "67f646e385366576c1168ccd31b41601ef05c1c52f2d712ab535dcb9aea850bf",
    ('lstm', 256, 1, 3, 512): "b092788a2933ce5a024562730ea76393e94c608bdae53610d5dfe7f99fda0958",
    ('lstm', 256, 13, 1, 11): "12759a9214ea5c94cfda2f9d8c64cd2ac6e323fd5222ac22b7232d5e43d1e2d1",
    ('lstm', 256, 13, 1, 512): "af89f015a340404117de3d1bc56b1f32dbc3b0127649e8666906101a53a98bbd",
    ('lstm', 256, 13, 3, 11): "e8690e60c3d643d200e83d2fd21b1349430b954d538b9a71077d15575f294928",
    ('lstm', 256, 13, 3, 512): "245b2be07848f477f23952cae390c9f481ba42f6c0cdb1dc8ed09fa5a0404504",
    ('lstm', 256, 1000, 1, 11): "cd84d90a437fc9670313be75962cf536b9ce8f8f7b7fd86a81d90f89a403bc34",
    ('lstm', 256, 1000, 1, 512): "1ddac84be0afc7b2995f89a8136ebb695a5a2b98ae3399bb52abd8203bf79f25",
    ('lstm', 256, 1000, 3, 11): "c499fb6345daa94a63933b266e230dbba9fe59b4e4971df9e6f31d370c5ed057",
    ('lstm', 256, 1000, 3, 512): "7d8f800cc0118fe90498a0e9bc6d144bc6f14cf706a217247083367b01ab7a5e",
    ('lstm', 256, 1029, 1, 11): "7b1e1c34b5cee880ce56efe4441e361d5d01bcf5806ffa0f9b36bddd1a38c46a",
    ('lstm', 256, 1029, 1, 512): "3380b32842dc2f6541605d4027f5318e0a57ce762e637df27251390c4cb76b6c",
    ('lstm', 256, 1029, 3, 11): "4a8e117f983d3ce67bbe43c90179b1b7a8c02aba2adf73bb1fb417cb4f44dccd",
    ('lstm', 256, 1029, 3, 512): "3ed0538a5752bff001fbaa70265e9a654beb66726e801ad80578e73d8a1c94ec",
}


def k1_digest(cell, hidden, rows, layers, cin, design=None):
    """sha256 over the bytes of K1's fp32 out and h_n and K2's fp32 out (the
    layers one launch each) on one case, in the design ``k1_plan`` picks or
    the one forced (``design``)."""
    dt = torch.float32
    rng = np.random.RandomState(1000 * hidden + 100 * layers + rows + cin)
    ly = [layer_weights(ld, dt, "cuda")
          for ld in init_rnn_params(rng, cin, hidden, layers, cell)]
    x = torch.from_numpy(rng.randn(21, rows, cin).astype(np.float32)).to("cuda")
    out, hn = bigru.birnn_stack(ly, x, dt, cell, design)
    out2 = bigru.birnn_layers(ly, x, dt, cell, design)[0]
    h = hashlib.sha256()
    for t in (out, hn, out2):
        h.update(t.contiguous().cpu().view(torch.uint8).numpy().tobytes())
    return h.hexdigest()


@pytest.mark.cuda
@pytest.mark.parametrize("case", K1_DIGEST_CASES)
def test_k1_simt_outputs_bit_equal_to_before_the_redesign(case):
    _need_card()
    assert bigru.k1_plan(case[1], case[0], torch.float32)["design"] == "simt"
    assert k1_digest(*case) == K1_DIGESTS[case]


# sha256 of ``k1_digest(*case)`` at 4,096 rows, 3 layers of H = 256 (57
# tiles of 72 rows a direction, several waves of clusters), taken on an
# H100 from the kernels as they were before the fp32 recurrence's
# four-warp redesign and the projection's proj_f32_kernel: the redesign
# leaves every bit as it was there too.
K1_WAVE_DIGESTS = {
    ('gru', 256, 4096, 3, 11): "d7c6ba3e3614f46bb85c10db0ee328de3ef8ae197f4e7a8e993e422dc335acf8",
    ('gru', 256, 4096, 3, 512): "42120e35d40737b37a94dfadb0294be5d394a6ada55e63510f6a7a4eb790e0a0",
    ('lstm', 256, 4096, 3, 11): "db8785ab6887bdd2a965d33c186ad19fd4d7d4ce12d0d8218b574e32486e3d36",
    ('lstm', 256, 4096, 3, 512): "44186a5c447957edfcd7a45e136d0b1f60720889827a045db6d9a683a09d1991",
}


@pytest.mark.cuda
@pytest.mark.parametrize("case", sorted(K1_WAVE_DIGESTS))
def test_k1_simt_outputs_bit_equal_at_several_waves(case):
    _need_card()
    assert bigru.k1_plan(case[1], case[0], torch.float32)["design"] == "simt"
    assert k1_digest(*case, design="simt") == K1_WAVE_DIGESTS[case]


@pytest.mark.cuda
@pytest.mark.parametrize("case", sorted(K1_WAVE_DIGESTS))
def test_k1_rows_small_window_keeps_the_wave_digests(case):
    """At 4,096 rows, in ``ROWS_SMALL_WINDOW``, the rule picks the rows
    design's 64-row geometry; K1's and K2's outputs there equal the
    digests taken on the simt design."""
    _need_card()
    cell, hidden, rows = case[:3]
    plan = bigru.k1_plan(hidden, cell, torch.float32, rows)
    assert (plan["design"], plan["rows"]) == ("rows", 64)
    assert k1_digest(*case) == K1_WAVE_DIGESTS[case]


# sha256 of ``k1_digest(*case)`` at the default batch's 1,024 rows, at
# ragged 1,000 and 1,031, at 504 and 506 (the 72-row tiles' last row count
# in one wave, and past it), and one row either side of ``ROWS_CROSSOVER``,
# 3 layers at C = 11 (and K2's one layer at C = 512 at the default batch's
# rows), taken on an H100 from ``birnn_rec_kernel`` and the rows design:
# the bits that any redesign of the default batch's recurrence keeps.
K1_DEFAULT_BATCH_DIGESTS = {
    ('gru', 256, 1000, 3, 11): "f507454f91356b10ed96180b1cbcd00489b8d439b0d27dace836dee367fef5c2",
    ('gru', 256, 1000, 1, 512): "580552feb9abc8dc74d862ce3a775c34b8dc770a2e669cecd871def5a3570e7c",
    ('gru', 256, 1024, 3, 11): "e3fd81c5c63a8aaaa7d4d56edd994a8d871e8f183dbabf03a64c981fb74f0c06",
    ('gru', 256, 1024, 1, 512): "a7123ae0fdc766fbc618f09e256a53d7bb3ef07c12d2a2168257cfd0b90c5690",
    ('gru', 256, 1031, 3, 11): "d482f3887facad41ea3b1445285c6e99fa844ad0aa88360b0094e55fde30a7e3",
    ('gru', 256, 1031, 1, 512): "fd5271afddd0da2cdc358a8e74d7e85b6f4f75910942d1d798f3f17faf8f921a",
    ('gru', 256, 504, 3, 11): "1f29aad7458e6cf097877893239687b6df9f8efddbbb11f1947c59fec6aa1145",
    ('gru', 256, 506, 3, 11): "1fd0a77b481275f33c0fa399412af0737bbfb75bfded5db2fc0d29adfb1d4c82",
    ('gru', 256, 6143, 3, 11): "5596c6189e52a27d986538254cb485d4dc35b967052599887446e1e59fd0f3c7",
    ('gru', 256, 6145, 3, 11): "7c4dcb22d006185d6dde817df4e1971210153e6afb845f893427d7031f5026ec",
    ('lstm', 256, 1000, 3, 11): "c499fb6345daa94a63933b266e230dbba9fe59b4e4971df9e6f31d370c5ed057",
    ('lstm', 256, 1000, 1, 512): "1ddac84be0afc7b2995f89a8136ebb695a5a2b98ae3399bb52abd8203bf79f25",
    ('lstm', 256, 1024, 3, 11): "013aa5279c3c60b1127853b01cb62cb818dd1eb7e5c6cb6ded6b409d3021ed42",
    ('lstm', 256, 1024, 1, 512): "bb87a01a26ba8207e40a37ef4796100fd309cf6252949d243f10063c0ce10ac0",
    ('lstm', 256, 1031, 3, 11): "106c36fa969f96adcd4196489cbedb2341377204bbbd518ae3a200913d2b6a21",
    ('lstm', 256, 1031, 1, 512): "38b21d818315312e64b0a3eec9e7783e95a2607db8a12f8ee9e735fca2385f6b",
    ('lstm', 256, 504, 3, 11): "32b499438fb6cbb38a7d90d660bac57af140c305106b12f0763bd7874de5d3a1",
    ('lstm', 256, 506, 3, 11): "6f6d84576df7fd0d9f3f85b308b65e816333a987cec561368e8ed352c097f75a",
    ('lstm', 256, 6143, 3, 11): "e9ac685d1735effccbe32496ab97be48b3e6dfbf9ca4ab29d67ce6006d0b4432",
    ('lstm', 256, 6145, 3, 11): "0f22c9775f5ffd0e912b1c2580b63b9390014fea563a4cb17404065f171fc164",
}


@pytest.mark.cuda
@pytest.mark.parametrize("case", sorted(K1_DEFAULT_BATCH_DIGESTS))
def test_k1_fp32_outputs_bit_equal_at_the_default_batch(case):
    """K1's and K2's fp32 outputs at the default batch, ragged batches and
    either side of the rows crossover, in the design ``k1_plan`` picks
    there, equal the digests: simt's 72-row tiles below the crossover, the
    rows design from it."""
    _need_card()
    cell, hidden, rows, layers, cin = case
    plan = bigru.k1_plan(hidden, cell, torch.float32, rows)
    if rows < bigru.ROWS_CROSSOVER:
        assert plan["design"] == "simt" and plan["rows"] == 72
    else:
        assert plan["design"] == "rows"
    assert k1_digest(*case) == K1_DEFAULT_BATCH_DIGESTS[case]


# sha256 of ``k1_digest(*case)`` at many rows, taken on an H100 from the
# kernels as they were before the rows design (the simt design ran these
# shapes): GRU and LSTM, H 256, 3 layers at C = 11 and 512 and K2's one
# layer at C = 512, at 16,384 rows (batch 8,192) and at 13 rows past the
# crossover (a ragged last block). The rows design that k1_plan now picks
# there leaves every bit as it was.
K1_ROWS_DIGESTS = {
    ('gru', 256, 16384, 3, 11): "b440e17c2a4b66c21a107a928c7401a6c239b3967f1531ae805ebc17e39f336f",
    ('gru', 256, 16384, 3, 512): "5ab1ac36c1cf017a887987036366587c5c8d95ec6788b84c1b264306846082dd",
    ('gru', 256, 16384, 1, 512): "f4d6516b7cc03c68ee17672b375b14b3cb66b4c273fe412f78f0fa2e92558bb0",
    ('gru', 256, 6157, 3, 11): "f296f0fa6aa4af616f65b24419e7697705ff7a64ad3533445f683ba0d8c660bc",
    ('gru', 256, 6157, 3, 512): "b71a0757627800930bce3300d0ea1bb4be4797a331992b25291ba3062c6232a0",
    ('lstm', 256, 16384, 3, 11): "b3a0fd096c3c7a2ca85684c1f75dc24b1d01459946bcffa1a5202865899ed951",
    ('lstm', 256, 16384, 3, 512): "1b49cf32cfbb27f6f2bdf3ed865ae05c330dae30e696d467edead0e08981e672",
    ('lstm', 256, 16384, 1, 512): "c7ccc548bb63c109ce6064d7bdbad0422230d584333bc6d8b2d8dd054c24e193",
    ('lstm', 256, 6157, 3, 11): "8b674afa86745b4a758db542c8404f24077ab70202e0fff192d2388b25738440",
    ('lstm', 256, 6157, 3, 512): "473e425d43f791fe73d7f2a419f5036a6c15738e7092bc093207d7884495566d",
}


@pytest.mark.cuda
@pytest.mark.parametrize("case", sorted(K1_ROWS_DIGESTS))
def test_k1_rows_outputs_bit_equal_to_the_cluster_design(case):
    _need_card()
    assert case[2] >= bigru.ROWS_CROSSOVER
    assert bigru.k1_plan(case[1], case[0], torch.float32, case[2])["design"] == "rows"
    assert k1_digest(*case) == K1_ROWS_DIGESTS[case]


# the earlier digests' cases that the rows design takes (H a multiple of 64)
ROWS_FORCED_CASES = ([c for c in K1_DIGEST_CASES if c[1] % 64 == 0]
                     + sorted(K1_WAVE_DIGESTS))


@pytest.mark.cuda
@pytest.mark.parametrize("case", ROWS_FORCED_CASES)
def test_k1_rows_design_keeps_the_earlier_digests(case):
    """The rows design forced on every shape of the earlier digests that it
    takes (H = 64 and 256, 1 to 4,096 rows, ragged blocks) gives their
    bits: K1's out and h_n and K2's out."""
    _need_card()
    want = K1_DIGESTS[case] if case in K1_DIGESTS else K1_WAVE_DIGESTS[case]
    assert k1_digest(*case, design="rows") == want


@pytest.mark.cuda
@pytest.mark.parametrize("layers", [1, 3])
@pytest.mark.parametrize("hidden", [64, 128, 256])
@pytest.mark.parametrize("rows", RAGGED + (6157,))
@pytest.mark.parametrize("cell", ["gru", "lstm"])
def test_rows_design_matches_plain_and_simt(cell, rows, hidden, layers):
    """K1 in the rows design, forced, at ragged row counts and one to four
    passes a step: two CUDA launches a layer, counted under its design;
    bit-equal on a rerun and to the simt design; within the fp32 tolerance
    of the plain version."""
    _need_card()
    dt = torch.float32
    ly, x = _stack(rows, hidden, cell, dt, layers)
    before, cuda_before = dict(bigru.design_calls), bigru.cuda_launches
    out, hn = bigru.birnn_stack(ly, x, dt, cell, "rows")
    assert bigru.cuda_launches - cuda_before == 2 * layers
    assert bigru.design_calls == dict(before, rows=before["rows"] + 1)
    out2, hn2 = bigru.birnn_stack(ly, x, dt, cell, "rows")
    simt_out, simt_hn = bigru.birnn_stack(ly, x, dt, cell, "simt")
    torch.cuda.synchronize()
    assert torch.equal(out, out2) and torch.equal(hn, hn2)
    assert torch.equal(out, simt_out) and torch.equal(hn, simt_hn)
    ref_out, ref_hn = bigru.birnn_stack_plain(ly, x, dt, cell)
    assert (out - ref_out).abs().max().item() <= TOL["float32"]
    assert (hn - ref_hn).abs().max().item() <= TOL["float32"]


@pytest.mark.cuda
@pytest.mark.parametrize("cell", ["gru", "lstm"])
def test_shape_rule_picks_rows_at_many_rows(cell):
    """At 16,384 rows (batch 8,192) fp32 K1 and K2 take the rows design: K1
    two CUDA launches a layer and one call under ``rows``, K2 (one layer a
    call) two a call and one call a layer under ``rows``; bf16 keeps tc."""
    _need_card()
    dt = torch.float32
    assert bigru.k1_plan(256, cell, torch.bfloat16, 16384)["design"] == "tc"
    ly, x = _stack(16384, 256, cell, dt)
    counts = _k2_counts()
    bigru.birnn_stack(ly, x, dt, cell)
    bigru.birnn_layers(ly, x, dt, cell)
    torch.cuda.synchronize()
    launches, cuda, designs, l_launches, l_cuda, l_designs, l_plain = _k2_counts()
    assert (launches - counts[0], cuda - counts[1]) == (1, 6)
    assert designs == dict(counts[2], rows=counts[2]["rows"] + 1)
    assert (l_launches - counts[3], l_cuda - counts[4], l_plain - counts[6]) == (3, 6, 0)
    assert l_designs == dict(counts[5], rows=counts[5]["rows"] + 3)


@pytest.mark.cuda
def test_rows_design_raises_on_what_it_cannot_take():
    """A forced rows design on an H it does not take, and a geometry the
    source does not instantiate, raise naming the shape; nothing launches
    and nothing falls back to another design."""
    _need_card()
    dt = torch.float32
    ly, x = _stack(37, 16, "gru", dt)
    before = (bigru.cuda_launches, dict(bigru.design_calls), bigru.plain_calls)
    with pytest.raises(ValueError, match="H = 16"):
        bigru.birnn_stack(ly, x, dt, "gru", "rows")
    ly, x = _stack(37, 256, "gru", dt, 1)
    wih, bih, whh, bhh = ly[0]
    xg = bigru.simt_projection(x.view(-1, 11), wih, bih, bhh, "gru")
    launched = bigru.cuda_launches
    plan = dict(bigru.rows_geometry(256, "gru", (96, 4)), design="rows")
    with pytest.raises(RuntimeError, match="birnn_rows recurrence \\(gru, H 256, 37 rows, R 96"):
        bigru.rows_recurrence(xg, whh, bhh, 21, 37, plan, "gru")
    assert bigru.cuda_launches == launched
    assert (before[1], before[2]) == (dict(bigru.design_calls), bigru.plain_calls)


@pytest.mark.cuda
def test_rows_sigmoid_is_sigmoid_f_on_every_float():
    """The rows design's epilogue takes sigmoid_f's reciprocal on its
    branch-free path (csrc/birnn_rows.cu's rcp_in_range) and the division
    outside that path's range: on every float32 bit pattern x its result
    has sigmoid_f's bits (NaN for NaN)."""
    _need_card()
    bad = torch.zeros(1, dtype=torch.int64, device="cuda")
    rc = bigru._load_rows().birnn_rows_sigmoid_check(
        bad.data_ptr(), torch.cuda.current_stream().cuda_stream, bad.device.index)
    torch.cuda.synchronize()
    assert rc == 0 and int(bad.item()) == 0

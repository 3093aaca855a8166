"""Kernels K3 (the transencoder2s encoder + mean: the fp32 design
ccsmeth_tpu_torch/ops/csrc/transenc_simt.cu, the bf16 design on wgmma and TMA
csrc/transenc_tc.cu and the first f32 kernel csrc/transenc_encoder.cu, kept
as the l2 design for the shapes the other two refuse) and K2 (one bidirectional GRU or LSTM layer in
K1's design: ccsmeth_tpu_torch/ops/csrc/birnn_simt.cu with K4's projection
in fp32, csrc/birnn_tc.cu in bf16) against their plain PyTorch versions on
the card. Needs a CUDA device and skips without one.

This file imports no JAX, so it also runs where JAX is not installed:
    python -m pytest --noconftest -m cuda tests/test_torch_transenc_kernels_cuda.py
(tests/conftest.py imports JAX).
"""

import numpy as np
import pytest
import torch

from ccsmeth_tpu_torch.models import TransEncConfig, init_transenc
from ccsmeth_tpu_torch.models.rnn import init_rnn_params, layer_weights
from ccsmeth_tpu_torch.models.transenc import randomize_affine
from ccsmeth_tpu_torch.ops import bigru, transenc

# K3's tolerances on the pooled (N, D) output, as in chip_smoke.py: fp32
# 1e-4, since the kernel and cuBLAS sum the products of six layers in other
# orders; bf16 2e-2: an f32 sum taken in another order can round a product
# operand (q, k, v, the context or the hidden layer) to the neighbouring bf16
# value, 2^-8 of it, and six layers carry that on
K3_TOL = {"float32": 1e-4, "bfloat16": 2e-2}
# K2's, as K1's (tests/test_torch_kernels_cuda.py)
K2_TOL = {"float32": 1e-5, "bfloat16": 1e-2}


def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("n,layers,d,ff", [(1024, 6, 256, 512), (37, 6, 256, 512),
                                           (50, 2, 64, 128)])
def test_encoder_kernel_matches_plain(dtype, n, layers, d, ff):
    """Full width at 2B = 1024 and at a ragged N (the last tile holds one
    sample), and one narrower shape (D = 64, FF = 128, three samples a
    block); random biases and LayerNorm parameters, different per layer."""
    _need_card()
    dt = getattr(torch, dtype)
    cfg = TransEncConfig(num_layers=layers, d_model=d, dim_ff=ff)
    params = randomize_affine(init_transenc(n, cfg), n)
    st = transenc.stack_layers(params["layers"], dt, "cuda")
    x = torch.from_numpy(np.random.RandomState(n).randn(n, 21, d).astype(np.float32))
    x = x.to("cuda", dt)
    before = transenc.launches
    got = transenc.encoder_pooled(st, x, dt, cfg.nhead)
    torch.cuda.synchronize()
    assert transenc.launches == before + 1
    ref = transenc.encoder_pooled_plain(st, x, dt, cfg.nhead)
    assert got.dtype == torch.float32 and got.shape == (n, d)
    assert bool(torch.isfinite(got).all())
    assert (got - ref).abs().max().item() <= K3_TOL[dtype]


def _encoder_case(n, dt, layers=6, d=256, ff=512, seed=0):
    cfg = TransEncConfig(num_layers=layers, d_model=d, dim_ff=ff)
    params = randomize_affine(init_transenc(seed + n, cfg), seed + n)
    st = transenc.stack_layers(params["layers"], dt, "cuda")
    x = torch.from_numpy(np.random.RandomState(seed + n).randn(n, 21, d)
                         .astype(np.float32)).to("cuda", dt)
    return cfg, st, x


@pytest.mark.cuda
@pytest.mark.parametrize("n", [1, 13, 1000, 1029])
def test_encoder_tc_design_matches_plain(n):
    """The bf16 tensor-core design at full width and ragged N (3 samples a
    CTA: the last tile holds 1, 1, 1 and 0 padded samples of 3), bit-equal
    on a rerun."""
    _need_card()
    dt = torch.bfloat16
    cfg, st, x = _encoder_case(n, dt)
    before = transenc.design_calls["tc"]
    got = transenc.encoder_pooled(st, x, dt, cfg.nhead)
    again = transenc.encoder_pooled(st, x, dt, cfg.nhead)
    torch.cuda.synchronize()
    assert transenc.design_calls["tc"] == before + 2
    assert torch.equal(got, again)
    ref = transenc.encoder_pooled_plain(st, x, dt, cfg.nhead)
    assert got.shape == (n, cfg.d_model) and bool(torch.isfinite(got).all())
    assert (got - ref).abs().max().item() <= K3_TOL["bfloat16"]


def _tc_call(st, x, cfg):
    """One encoder_pooled call in bf16 that must take the tc design: its
    output and the CUDA launches and tc calls it counted."""
    before, cuda_before = transenc.design_calls["tc"], transenc.cuda_launches
    got = transenc.encoder_pooled(st, x, torch.bfloat16, cfg.nhead)
    return got, transenc.cuda_launches - cuda_before, transenc.design_calls["tc"] - before


@pytest.mark.cuda
@pytest.mark.parametrize("n", [2, 3, 4, 395, 396, 397])
def test_encoder_tc_ragged_last_tile_and_full_waves(n):
    """CTAs of 3 samples: n = 2, 4 and 395 leave the last tile part-filled,
    n = 3 is one full tile, n = 396 fills one wave of 132 CTAs and n = 397
    starts a second with one sample; one CUDA launch a call, bit-equal on a
    rerun, within K3's bf16 tolerance of the plain version."""
    _need_card()
    dt = torch.bfloat16
    cfg, st, x = _encoder_case(n, dt, seed=9)
    plan = transenc.k3_plan(21, cfg.d_model, cfg.dim_ff, cfg.nhead, dt)
    assert (plan["design"], plan["S"]) == ("tc", 3)
    got, cuda, calls = _tc_call(st, x, cfg)
    again, cuda2, _ = _tc_call(st, x, cfg)
    torch.cuda.synchronize()
    assert (cuda, cuda2, calls) == (1, 1, 1)
    assert torch.equal(got, again)
    ref = transenc.encoder_pooled_plain(st, x, dt, cfg.nhead)
    assert got.shape == (n, cfg.d_model) and bool(torch.isfinite(got).all())
    assert (got - ref).abs().max().item() <= K3_TOL["bfloat16"]


@pytest.mark.cuda
@pytest.mark.parametrize("ff", [256, 128])
def test_encoder_tc_design_at_a_narrower_width(ff):
    """D = 128, 2 heads of 64, FF 256 or 128: a warpgroup's residual is one
    m64n64 tile and a ring tile one box; one launch a call, bit-equal
    reruns."""
    _need_card()
    dt = torch.bfloat16
    nhead = 2
    cfg = TransEncConfig(num_layers=3, d_model=128, dim_ff=ff, nhead=nhead)
    params = randomize_affine(init_transenc(ff, cfg), ff)
    st = transenc.stack_layers(params["layers"], dt, "cuda")
    x = torch.from_numpy(np.random.RandomState(ff).randn(301, 21, 128)
                         .astype(np.float32)).to("cuda", dt)
    assert transenc.k3_plan(21, 128, ff, nhead, dt)["design"] == "tc"
    got, cuda, calls = _tc_call(st, x, cfg)
    again, _, _ = _tc_call(st, x, cfg)
    torch.cuda.synchronize()
    assert (cuda, calls) == (1, 1) and torch.equal(got, again)
    ref = transenc.encoder_pooled_plain(st, x, dt, nhead)
    assert (got - ref).abs().max().item() <= K3_TOL["bfloat16"]


@pytest.mark.cuda
@pytest.mark.parametrize("stages", [2, 3, 6])
def test_encoder_tc_ring_depths_give_the_same_bits(stages, tmp_path):
    """A build of the source with another ring depth (-DTE_STAGES) gives the
    shipped build's output bit for bit at D = 256: the ring changes when a
    tile arrives, not what is summed or in which order."""
    import subprocess

    from ccsmeth_tpu_torch.ops import nvcc

    _need_card()
    dt = torch.bfloat16
    cfg, st, x = _encoder_case(200, dt, seed=4)
    want = transenc.encoder_pooled(st, x, dt, cfg.nhead)
    so = str(tmp_path / "transenc_tc_{}.so".format(stages))
    subprocess.run([nvcc._nvcc()] + nvcc.NVCC_FLAGS + ["-DTE_STAGES={}".format(stages),
                    "-I", nvcc.CSRC, "-o", so, "{}/{}".format(nvcc.CSRC, transenc.TC_SRC)],
                   check=True, capture_output=True)
    shipped, transenc._tc_lib = transenc._load_tc(), transenc.bind_tc(so)
    try:
        got = transenc.encoder_pooled(st, x, dt, cfg.nhead)
        torch.cuda.synchronize()
    finally:
        transenc._tc_lib = shipped
    assert torch.equal(got, want), stages


@pytest.mark.cuda
@pytest.mark.parametrize("d,ff,nhead", [(64, 128, 4), (256, 640, 4), (128, 256, 4)])
def test_encoder_bf16_shapes_tc_refuses_take_l2(d, ff, nhead):
    """bf16 shapes the tc design refuses (D = 64; FF not a multiple of D;
    heads of width 32) take the l2 kernel: one CUDA launch, counted as
    l2's, within K3's bf16 tolerance of the plain version."""
    _need_card()
    dt = torch.bfloat16
    cfg = TransEncConfig(num_layers=2, d_model=d, dim_ff=ff, nhead=nhead)
    params = randomize_affine(init_transenc(d + ff, cfg), d + ff)
    st = transenc.stack_layers(params["layers"], dt, "cuda")
    x = torch.from_numpy(np.random.RandomState(d).randn(50, 21, d)
                         .astype(np.float32)).to("cuda", dt)
    assert transenc.k3_plan(21, d, ff, nhead, dt)["design"] == "l2"
    before, cuda_before = transenc.design_calls["l2"], transenc.cuda_launches
    got = transenc.encoder_pooled(st, x, dt, cfg.nhead)
    torch.cuda.synchronize()
    assert transenc.design_calls["l2"] == before + 1
    assert transenc.cuda_launches == cuda_before + 1
    ref = transenc.encoder_pooled_plain(st, x, dt, cfg.nhead)
    assert (got - ref).abs().max().item() <= K3_TOL["bfloat16"]


@pytest.mark.cuda
@pytest.mark.parametrize("n", [1, 2, 3, 37, 1024, 1029])
def test_encoder_simt_design_matches_plain(n):
    """The fp32 design at full width and ragged N (3 samples a CTA: the
    last tile holds 1, 2, 3, 1, 1 and 0 padded samples of 3), one CUDA
    launch a call, bit-equal on a rerun."""
    _need_card()
    dt = torch.float32
    cfg, st, x = _encoder_case(n, dt, seed=3)
    assert transenc.k3_plan(21, cfg.d_model, cfg.dim_ff, cfg.nhead, dt)["design"] == "simt"
    before, cuda_before = transenc.design_calls["simt"], transenc.cuda_launches
    got = transenc.encoder_pooled(st, x, dt, cfg.nhead)
    again = transenc.encoder_pooled(st, x, dt, cfg.nhead)
    torch.cuda.synchronize()
    assert transenc.design_calls["simt"] == before + 2
    assert transenc.cuda_launches == cuda_before + 2
    assert torch.equal(got, again)
    ref = transenc.encoder_pooled_plain(st, x, dt, cfg.nhead)
    assert got.shape == (n, cfg.d_model) and bool(torch.isfinite(got).all())
    assert (got - ref).abs().max().item() <= K3_TOL["float32"]


@pytest.mark.cuda
def test_encoder_shape_rule_picks_the_design():
    """transencoder2s's shape takes the tensor-core design in bf16 and the
    simt design in fp32; a D that both refuse (D = 36: not a multiple of 32
    for tc, nor of 8 for simt) takes the l2 kernel in bf16 and fp32, and
    each still matches the plain version."""
    _need_card()
    for d, ff, dt, design in ((256, 512, torch.bfloat16, "tc"),
                              (256, 512, torch.float32, "simt"),
                              (36, 64, torch.bfloat16, "l2"),
                              (36, 64, torch.float32, "l2")):
        cfg, st, x = _encoder_case(64, dt, layers=2, d=d, ff=ff)
        assert transenc.k3_plan(21, d, ff, cfg.nhead, dt)["design"] == design
        before, cuda_before = dict(transenc.design_calls), transenc.cuda_launches
        got = transenc.encoder_pooled(st, x, dt, cfg.nhead)
        torch.cuda.synchronize()
        assert transenc.cuda_launches == cuda_before + 1
        for key in before:
            assert transenc.design_calls[key] == before[key] + (key == design), key
        ref = transenc.encoder_pooled_plain(st, x, dt, cfg.nhead)
        assert (got - ref).abs().max().item() <= K3_TOL[str(dt).split(".")[1]]


@pytest.mark.cuda
@pytest.mark.parametrize("n", [37, 1024])
def test_encoder_l2_design_called_directly_matches_plain(n):
    """The kept first f32 kernel at transencoder2s's fp32 shape, which the
    rule now sends to simt: called directly, it still matches the plain
    version and reruns bit-equal."""
    _need_card()
    dt = torch.float32
    cfg, st, x = _encoder_case(n, dt, seed=5)
    before = transenc.design_calls["l2"]
    got = transenc._encoder_l2(st, x, dt, cfg.nhead)
    again = transenc._encoder_l2(st, x, dt, cfg.nhead)
    torch.cuda.synchronize()
    assert transenc.design_calls["l2"] == before + 2 and torch.equal(got, again)
    ref = transenc.encoder_pooled_plain(st, x, dt, cfg.nhead)
    assert (got - ref).abs().max().item() <= K3_TOL["float32"]


@pytest.mark.cuda
def test_encoder_kernel_rejects_what_it_cannot_take():
    _need_card()
    cfg = TransEncConfig(num_layers=1, d_model=64, dim_ff=128)
    st = transenc.stack_layers(init_transenc(0, cfg)["layers"], torch.float32, "cuda")
    with pytest.raises(ValueError):  # L > 32
        transenc.encoder_pooled(st, torch.zeros((2, 33, 64), device="cuda"))
    with pytest.raises(TypeError):  # x not in the operand type
        transenc.encoder_pooled(st, torch.zeros((2, 21, 64), device="cuda",
                                                dtype=torch.bfloat16))


def _k2_counts():
    return (bigru.launches, bigru.cuda_launches, dict(bigru.design_calls),
            bigru.layer_launches, bigru.layer_cuda_launches,
            dict(bigru.layer_design_calls), bigru.layer_plain_calls)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("cell", ["gru", "lstm"])
@pytest.mark.parametrize("rows,cin,hidden", [(1024, 11, 256), (1024, 512, 256),
                                             (13, 11, 64), (1, 512, 256),
                                             (1029, 11, 256)])
def test_layer_kernel_matches_plain(dtype, cell, rows, cin, hidden):
    """One layer at the call_mods path's shapes (layer 0: C = 11, layers 1
    and 2: C = 2H) and ragged row counts, in the design the shape rule picks
    (simt in fp32, tc in bf16): two CUDA launches (one in tc where the
    projection fuses, C = 11), counted as K2's and not K1's, bit-equal on a
    rerun. Through ``birnn_layers`` h_n is the stored
    output at each direction's last step, widened."""
    _need_card()
    dt = getattr(torch, dtype)
    design = bigru.k1_plan(hidden, cell, dt)["design"]
    assert design == ("simt" if dtype == "float32" else "tc")
    rng = np.random.RandomState(rows + cin)
    ly = layer_weights(init_rnn_params(rng, cin, hidden, 1, cell)[0], dt, "cuda")
    x = torch.from_numpy(rng.randn(21, rows, cin).astype(np.float32)).to("cuda", dt)
    before = _k2_counts()
    out = bigru.bigru_layer_tm(ly, x, dt, cell)
    after = _k2_counts()
    assert after[:3] == before[:3]  # nothing of K1's
    fused = design == "tc" and bigru.tc_fused_kx(bigru.k1_plan(hidden, cell), cin, cell, hidden)
    assert (after[3] - before[3], after[4] - before[4]) == (1, 1 if fused else 2)
    assert after[5][design] - before[5][design] == 1 and after[6] == before[6]
    again, hn = bigru.birnn_layers([ly], x, dt, cell)
    torch.cuda.synchronize()
    assert torch.equal(out, again)
    assert torch.equal(hn[0], out[-1, :, :hidden].float())
    assert torch.equal(hn[1], out[0, :, hidden:].float())
    ref = bigru.bigru_layer_tm_plain(ly, x, dt, cell)
    assert out.dtype == dt and out.shape == (21, rows, 2 * hidden)
    assert (out.float() - ref.float()).abs().max().item() <= K2_TOL[dtype]


@pytest.mark.cuda
@pytest.mark.parametrize("hidden,rows", [(32, 13), (64, 1029), (256, 300)])
@pytest.mark.parametrize("cell", ["gru", "lstm"])
def test_layers_equal_the_stack_kernel_in_fp32(cell, hidden, rows):
    """K2 runs K1's launches one layer at a time, so in fp32 the stack
    through K2 equals K1's output and h_n (K2's rebuilt from the outputs,
    which hold the f32 state) bit for bit; K2 counts its own calls and CUDA
    launches, K1's stay."""
    _need_card()
    rng = np.random.RandomState(7 + hidden)
    ly = [layer_weights(ld, torch.float32, "cuda")
          for ld in init_rnn_params(rng, 11, hidden, 3, cell)]
    x = torch.from_numpy(rng.randn(21, rows, 11).astype(np.float32)).cuda()
    before = _k2_counts()
    out, hn = bigru.birnn_layers(ly, x, torch.float32, cell)
    after = _k2_counts()
    assert after[:3] == before[:3]
    assert (after[3] - before[3], after[4] - before[4]) == (3, 6)
    assert after[5]["simt"] - before[5]["simt"] == 3
    out1, hn1 = bigru.birnn_stack(ly, x, torch.float32, cell)
    torch.cuda.synchronize()
    assert torch.equal(out, out1) and torch.equal(hn, hn1)


# ---- K3's fp32 (simt) design held to sha256 digests of its outputs, taken
# on an H100 from the tree before its redesign for Hopper: the new design
# keeps every product's fmaf chain, the feed-forward's chunk sums, the
# residual adds, LayerNorm's and attention's orders and the mean, so its
# output is the old one bit for bit. Cases (n, layers, D, FF, heads, L):
# full width at n = 1, 2, 3, 37, 1,024 and 1,029 (ragged last tiles), and
# narrower shapes the simt design takes: FF 208 and 400 (hidden chunks of
# 192 + 16 and 192 + 192 + 16), D 64, 128 and 48 (heads of 16, 16 and 12),
# L 32, 11 and 1 (2, 5 and 64 samples a tile). The digests of a tree print
# with
#     python -c "import sys; sys.path[:0] = ['.', 'tests']; import test_torch_transenc_kernels_cuda as t; t.print_k3_digests()"
# from that tree's root.
K3_CASES = ([(n, 6, 256, 512, 4, 21) for n in (1, 2, 3, 37, 1024, 1029)]
            + [(50, 2, 256, 208, 4, 21), (50, 2, 256, 400, 4, 21), (50, 2, 64, 128, 4, 21),
               (61, 2, 128, 256, 8, 21), (29, 2, 48, 96, 4, 21), (40, 2, 256, 512, 4, 32),
               (77, 2, 256, 512, 4, 11), (200, 1, 64, 64, 2, 1)])


def k3_digest(case):
    """sha256 of K3's fp32 output on one case (inputs from numpy seeds)."""
    import hashlib

    n, layers, d, ff, nhead, seq = case
    seed = n + 3 * d + 5 * ff + 7 * nhead + 11 * seq + layers
    cfg = TransEncConfig(num_layers=layers, d_model=d, dim_ff=ff, nhead=nhead)
    params = randomize_affine(init_transenc(seed, cfg), seed)
    st = transenc.stack_layers(params["layers"], torch.float32, "cuda")
    x = torch.from_numpy(np.random.RandomState(seed).randn(n, seq, d)
                         .astype(np.float32)).to("cuda")
    out = transenc.encoder_pooled(st, x, torch.float32, nhead)
    torch.cuda.synchronize()
    return hashlib.sha256(out.cpu().numpy().tobytes()).hexdigest()


def print_k3_digests():
    """Each case's digest, as K3_DIGESTS holds them."""
    for case in K3_CASES:
        print("    {!r}: {!r},".format(case, k3_digest(case)), flush=True)


# ``k3_digest(case)``, taken on "NVIDIA H100 80GB HBM3, 700.00 W" from the
# tree before the redesign (the simt design's cp.async ring)
K3_DIGESTS = {
    (1, 6, 256, 512, 4, 21): 'b9ae215c694aa496956e3ba5066c0b43f82d700807a6ecf0d27d9061a5332748',
    (2, 6, 256, 512, 4, 21): 'b67518d142d990d4643048e9412141d53577ef1648be68d1e3634a86b3f3a6a5',
    (3, 6, 256, 512, 4, 21): 'bd211dae3d15f95bd0e667b4d1c314fd61fbfe64a16815e46b2d617962811def',
    (37, 6, 256, 512, 4, 21): 'dc540f5b94b87b31f8939930f7c63c0bbb7f3c20d7bae828a199e109bf00e119',
    (1024, 6, 256, 512, 4, 21): '36023cf196d9953e5ec72f85cf00f4cce910ed591c2ffe6a259926d395fde0b9',
    (1029, 6, 256, 512, 4, 21): '6fc5bc558ffd6d93973fb641032907e7f96c8d071e24410805be2872f1bd23cc',
    (50, 2, 256, 208, 4, 21): '235fc7933396e063933f893fa4c9a537abd97e68e5e57e7ad83170efb324e45c',
    (50, 2, 256, 400, 4, 21): 'a8c2e7f4d6c674313dca95d3118667a911703868e1e0867ca6ad672305eb3f64',
    (50, 2, 64, 128, 4, 21): '9914407c2445281a8c83aff9379a6c2fcf92367e041b4fdb44ba0fac8d9445f2',
    (61, 2, 128, 256, 8, 21): 'df577b9cc67d9df33ddaf601f78309b36a52471eb31ac850d092f2c20f8f2d4d',
    (29, 2, 48, 96, 4, 21): '12c8cf22f1049534dbd598268e77da6fc7de2bccd5955281e2605a89f9018669',
    (40, 2, 256, 512, 4, 32): 'dc261bc04ff59f93039a738900a0666a61c6fc6ff3ea4295c50f3061f4418572',
    (77, 2, 256, 512, 4, 11): 'c888480756245eabb017fd054a7b771a8c700ab22def9564e20cf0f5aa1205c0',
    (200, 1, 64, 64, 2, 1): 'c71579698cf8e34d802814e43e86444ae622c4de48ad3215e5470b7434c4d7c2',
}


@pytest.mark.cuda
@pytest.mark.parametrize("case", K3_CASES)
def test_encoder_simt_bit_equal_to_the_parent_digests(case):
    """The fp32 design gives the old design's output bit for bit on every
    case, and again on a rerun."""
    _need_card()
    n, layers, d, ff, nhead, seq = case
    assert transenc.k3_plan(seq, d, ff, nhead, torch.float32)["design"] == "simt"
    assert k3_digest(case) == K3_DIGESTS[case]
    assert k3_digest(case) == K3_DIGESTS[case]

"""Kernels K3 (ccsmeth_tpu_torch/ops/csrc/transenc_encoder.cu, the
transencoder2s encoder + mean) and K2 (bigru_layer_launch in
ccsmeth_tpu_torch/ops/csrc/bigru_stack.cu, one bidirectional GRU or LSTM
layer) against their plain PyTorch versions on the card. Needs a CUDA device
and skips without one.

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


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("cell", ["gru", "lstm"])
@pytest.mark.parametrize("rows,cin,hidden", [(1024, 11, 256), (1024, 512, 256),
                                             (13, 11, 64)])
def test_layer_kernel_matches_plain(dtype, cell, rows, cin, hidden):
    """One layer at the call_mods path's shapes (layer 0: C = 11, layers 1
    and 2: C = 2H) and a ragged small tile."""
    _need_card()
    dt = getattr(torch, dtype)
    rng = np.random.RandomState(rows + cin)
    ly = layer_weights(init_rnn_params(rng, cin, hidden, 1, cell)[0], dt, "cuda")
    x = torch.from_numpy(rng.randn(21, rows, cin).astype(np.float32)).to("cuda", dt)
    before = bigru.layer_launches, bigru.launches
    out = bigru.bigru_layer_tm(ly, x, dt, cell)
    torch.cuda.synchronize()
    assert (bigru.layer_launches, bigru.launches) == (before[0] + 1, before[1])
    ref = bigru.bigru_layer_tm_plain(ly, x, dt, cell)
    assert out.dtype == dt and out.shape == (21, rows, 2 * hidden)
    assert (out.float() - ref.float()).abs().max().item() <= K2_TOL[dtype]


@pytest.mark.cuda
@pytest.mark.parametrize("cell", ["gru", "lstm"])
def test_layers_equal_the_stack_kernel_in_fp32(cell):
    """K2 runs K1's device code one layer at a time, so in fp32 the stack
    through K2 equals K1's output and h_n bit for bit."""
    _need_card()
    rng = np.random.RandomState(7)
    ly = [layer_weights(ld, torch.float32, "cuda")
          for ld in init_rnn_params(rng, 11, 256, 3, cell)]
    x = torch.from_numpy(rng.randn(21, 300, 11).astype(np.float32)).cuda()
    out, hn = bigru.birnn_layers(ly, x, torch.float32, cell)
    out1, hn1 = bigru.birnn_stack(ly, x, torch.float32, cell)
    torch.cuda.synchronize()
    assert torch.equal(out, out1) and torch.equal(hn, hn1)

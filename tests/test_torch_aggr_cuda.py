"""Kernel K1 at call_freqb's aggregate shape on the card (NL 1, H 32, L 11,
C 21 = 20 histogram bins + the offset, fp32: the simt design, K4's projection
and ``birnn_simt.cu``'s recurrence, U = 32, one CTA a cluster), both cells,
against its plain version, with bit-equal reruns, a row that does not depend
on the batch around it, and the aggregate predictor on cuda against cpu.
Needs a CUDA device and skips without one.

This file imports no JAX, so it also runs where JAX is not installed:
    python -m pytest --noconftest -m cuda tests/test_torch_aggr_cuda.py
"""

import numpy as np
import pytest
import torch

from ccsmeth_tpu_torch.models import AggrConfig, init_aggr_attrnn
from ccsmeth_tpu_torch.models.params_io import save_params
from ccsmeth_tpu_torch.models.rnn import init_rnn_params, layer_weights
from ccsmeth_tpu_torch.ops import bigru

H, L, C = 32, 11, 21
TOL = 1e-5  # fp32, as chip_smoke.py's


def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")


def _inputs(cell, rows, seed=0):
    rng = np.random.RandomState(seed + rows)
    ly = [layer_weights(ld, torch.float32, "cuda")
          for ld in init_rnn_params(rng, C, H, 1, cell)]
    x = torch.from_numpy(rng.rand(L, rows, C).astype(np.float32)).cuda()
    return ly, x


@pytest.mark.cuda
@pytest.mark.parametrize("rows", [1, 7, 1000, 1024, 1029])
@pytest.mark.parametrize("cell", ["gru", "lstm"])
def test_k1_at_the_aggregate_shape(cell, rows):
    _need_card()
    plan = bigru.k1_plan(H, cell, torch.float32)
    assert (plan["design"], plan["U"], plan["CN"]) == ("simt", 32, 1), plan
    ly, x = _inputs(cell, rows)
    before = bigru.cuda_launches
    out, hn = bigru.birnn_stack(ly, x, torch.float32, cell)
    torch.cuda.synchronize()
    assert bigru.cuda_launches - before == 2  # the projection and the recurrence
    out2, hn2 = bigru.birnn_stack(ly, x, torch.float32, cell)
    assert torch.equal(out, out2) and torch.equal(hn, hn2)
    ref_out, ref_hn = bigru.birnn_stack_plain(ly, x, torch.float32, cell)
    assert out.shape == (L, rows, 2 * H) and hn.shape == (2, rows, H)
    assert (out - ref_out).abs().max().item() <= TOL
    assert (hn - ref_hn).abs().max().item() <= TOL


@pytest.mark.cuda
@pytest.mark.parametrize("cell", ["gru", "lstm"])
def test_a_row_alone_equals_the_row_in_a_full_batch(cell):
    """call_freqb pads the last batch of a run: a window's result must not
    depend on which batch, or which place in it, it sits."""
    _need_card()
    ly, x = _inputs(cell, 1024)
    out, hn = bigru.birnn_stack(ly, x, torch.float32, cell)
    for i in (0, 63, 64, 1023):
        o1, h1 = bigru.birnn_stack(ly, x[:, i:i + 1].contiguous(), torch.float32, cell)
        assert torch.equal(o1[:, 0], out[:, i]) and torch.equal(h1[:, 0], hn[:, i]), i


@pytest.mark.cuda
@pytest.mark.parametrize("model_type", ["attbigru", "attbilstm"])
def test_aggr_predictor_cuda_matches_cpu(tmp_path, model_type):
    """2,500 windows, 3 padded batches: one K1 call (2 CUDA launches, simt) a
    batch; raw outputs to 1e-5; the rounded probs equal except at most
    max(1, rows // 200), the aggregate mode's allowance."""
    _need_card()
    from ccsmeth_tpu_torch.pipeline.call_freq_bam import AggrPredictor, FreqBamConfig

    npz = str(tmp_path / "aggr.npz")
    save_params(npz, init_aggr_attrnn(3, AggrConfig(model_type=model_type)))
    rng = np.random.RandomState(1)
    n = 2500
    offsets = rng.randint(0, 400, (n, L)).astype(np.float32)
    hist = rng.randint(0, 6, (n, L, 20)).astype(np.float32)
    histos = np.round(hist / np.maximum(np.linalg.norm(hist, axis=2, keepdims=True),
                                        1.0), 6).astype(np.float32)
    preds = {dev: AggrPredictor(FreqBamConfig(aggre_model=npz, model_type=model_type,
                                              device=dev)) for dev in ("cuda", "cpu")}
    before = (bigru.launches, bigru.cuda_launches, bigru.design_calls["simt"])
    raw = preds["cuda"].raw(offsets, histos)
    after = (bigru.launches, bigru.cuda_launches, bigru.design_calls["simt"])
    assert [a - b for a, b in zip(after, before)] == [3, 6, 3]
    assert preds["cuda"].batches == 3 and preds["cuda"].rows == 3 * 1024
    want = preds["cpu"].raw(offsets, histos)
    assert np.abs(raw - want).max() <= TOL
    p_cuda = preds["cuda"].predict(offsets, histos)
    p_cpu = preds["cpu"].predict(offsets, histos)
    assert p_cuda.dtype == np.float32
    assert int((p_cuda != p_cpu).sum()) <= max(1, n // 200)

"""The kernels at the embedded-kinetics families' input widths on the card:
attbigru2s2 / attbilstm2s2 feed their BiRNN C = 28 channels (8 + 2 x 8 + 4)
at the defaults and C = 52 with stds, sn and map, where every model before
them fed 11 or 21. K1 in both designs (simt fp32, tc bf16, whose layer 0
runs its projection inside the recurrence kernel where W_ih's slice fits,
else on the mma.sync GEMM for C % 8 != 0) and K2 at C = 28 and 52, K4/K5
and K6 at C = 28 (layer 0 of a 2s2 model in training; the dx product writes
28 columns), each against its plain version, with bit-equal reruns and a row
that does not depend on the batch around it; and a full-width 2s2 model
through K1 against the plain version. Needs a CUDA device and skips without
one.

This file imports no JAX, so it also runs where JAX is not installed:
    python -m pytest --noconftest -m cuda tests/test_torch_embed_cuda.py
"""

import numpy as np
import pytest
import torch

from ccsmeth_tpu_torch.models import AttRNNConfig, init_attrnn
from ccsmeth_tpu_torch.models.rnn import init_rnn_params, layer_weights
from ccsmeth_tpu_torch.ops import bigru, bigru_vjp, bilstm_vjp

NL, H, L = 3, 256, 21
# K1 / K2 outputs as chip_smoke.py holds them: fp32 1e-5, bf16 1e-2
TOL = {"float32": 1e-5, "bfloat16": 1e-2}
DESIGN = {"float32": "simt", "bfloat16": "tc"}


def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False  # the plain versions' products


def _stack(cell, cin, rows, dt, n_layers=NL, seed=0):
    rng = np.random.RandomState(seed + cin + rows)
    ly = [layer_weights(ld, dt, "cuda")
          for ld in init_rnn_params(rng, cin, H, n_layers, cell)]
    x = torch.from_numpy(rng.randn(L, rows, cin).astype(np.float32)).to("cuda", dt)
    return ly, x


def _launches(cell, dtype, cin):
    """CUDA launches of one K1 call (K2's over the stack): two a layer, one
    for a tc layer 0 whose projection fuses; and of K2's layer 0."""
    plan = bigru.k1_plan(H, cell, getattr(torch, dtype))
    one = 1 if plan["design"] == "tc" and bigru.tc_fused_kx(plan, cin, cell, H) else 2
    return 2 * (NL - 1) + one, one


def _err(a, b):
    return (a.float() - b.float()).abs().max().item()


@pytest.mark.cuda
@pytest.mark.parametrize("rows", [1024, 1029])
@pytest.mark.parametrize("cin", [28, 52])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("cell", ["gru", "lstm"])
def test_k1_at_the_embedded_widths(cell, dtype, cin, rows):
    _need_card()
    dt = getattr(torch, dtype)
    assert bigru.k1_plan(H, cell, dt)["design"] == DESIGN[dtype]
    ly, x = _stack(cell, cin, rows, dt)
    designs = dict(bigru.design_calls)
    bigru.cuda_launches = 0
    out, hn = bigru.birnn_stack(ly, x, dt, cell)
    assert bigru.cuda_launches == _launches(cell, dtype, cin)[0]
    out2, hn2 = bigru.birnn_stack(ly, x, dt, cell)
    torch.cuda.synchronize()
    assert bigru.design_calls[DESIGN[dtype]] == designs[DESIGN[dtype]] + 2
    assert torch.equal(out, out2) and torch.equal(hn, hn2)
    ref_out, ref_hn = bigru.birnn_stack_plain(ly, x, dt, cell)
    assert out.shape == (L, rows, 2 * H) and hn.shape == (2 * NL, rows, H)
    assert bool(torch.isfinite(out.float()).all())
    assert _err(out, ref_out) <= TOL[dtype] and _err(hn, ref_hn) <= TOL[dtype]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("cell", ["gru", "lstm"])
def test_k1_row_alone_equals_the_row_in_a_batch(cell, dtype):
    """call_mods pads its last batch: at C = 28 a site's result must not
    depend on the batch, or the place in it, that it sits in."""
    _need_card()
    dt = getattr(torch, dtype)
    ly, x = _stack(cell, 28, 1024, dt)
    out, hn = bigru.birnn_stack(ly, x, dt, cell)
    for i in (0, 63, 64, 1023):
        o1, h1 = bigru.birnn_stack(ly, x[:, i:i + 1].contiguous(), dt, cell)
        assert torch.equal(o1[:, 0], out[:, i]) and torch.equal(h1[:, 0], hn[:, i]), i


@pytest.mark.cuda
@pytest.mark.parametrize("cin", [28, 52])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("cell", ["gru", "lstm"])
def test_k2_at_the_embedded_widths(cell, dtype, cin):
    """K2, one layer a launch (--rnn_backend pallas_layer): layer 0 of a 2s2
    model, and the whole stack through birnn_layers, against the plain
    versions; K1 launches nothing."""
    _need_card()
    dt = getattr(torch, dtype)
    ly, x = _stack(cell, cin, 1024, dt)
    k1 = (bigru.launches, bigru.cuda_launches)
    bigru.layer_cuda_launches = 0
    out = bigru.bigru_layer_tm(ly[0], x, dt, cell)
    assert bigru.layer_cuda_launches == _launches(cell, dtype, cin)[1]
    again = bigru.bigru_layer_tm(ly[0], x, dt, cell)
    torch.cuda.synchronize()
    assert torch.equal(out, again)
    assert _err(out, bigru.bigru_layer_tm_plain(ly[0], x, dt, cell)) <= TOL[dtype]
    stack_out, stack_hn = bigru.birnn_layers(ly, x, dt, cell)
    ref_out, _ = bigru.birnn_stack_plain(ly, x, dt, cell)
    assert (bigru.launches, bigru.cuda_launches) == k1
    assert stack_hn.shape == (2 * NL, 1024, H)
    assert _err(stack_out, ref_out) <= (TOL[dtype] if dtype == "float32" else 2e-2)


def _grad_tol(name, ref, dt):
    """As the K4/K5 and K6 card tests: fp32 dx 1e-5, dW and db 1e-5 of
    max|ref| + 1e-5 (sums of L x rows products in another order); bf16 1e-2
    of max|ref| + 1e-5 (a gate-gradient operand rounded the other way)."""
    if dt == torch.float32 and name == "dx":
        return 1e-5
    scale = ref.abs().max().item()
    return (1e-5 if dt == torch.float32 else 1e-2) * scale + 1e-5


@pytest.mark.cuda
@pytest.mark.parametrize("rows", [1024, 1000])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("cell", ["gru", "lstm"])
def test_training_kernels_at_c28(cell, dtype, rows):
    """K4/K5 (GRU) or K6 (LSTM) on layer 0 of a 2s2 model in training (C =
    28): the forward's outputs and residuals and the backward's dx (28
    columns), weight and bias gradients against the plain versions, both
    run twice for bit-equal results."""
    _need_card()
    dt = getattr(torch, dtype)
    V = bigru_vjp if cell == "gru" else bilstm_vjp
    fwd, fwd_plain = ((V.bigru_layer_train_fwd, V.bigru_layer_train_fwd_plain)
                      if cell == "gru" else
                      (V.bilstm_layer_train_fwd, V.bilstm_layer_train_fwd_plain))
    bwd, bwd_plain = ((V.bigru_layer_bwd, V.bigru_layer_bwd_plain) if cell == "gru" else
                      (V.bilstm_layer_bwd, V.bilstm_layer_bwd_plain))
    ly, x = _stack(cell, 28, rows, dt, n_layers=1)
    wih, bih, whh, bhh = ly[0]
    dout = torch.from_numpy(np.random.RandomState(rows).randn(L, rows, 2 * H)
                            .astype(np.float32)).to("cuda", dt)
    V.cuda_launches = 0
    res = fwd(x, wih, bih, whh, bhh, dt)
    assert V.cuda_launches == 2
    res2 = fwd(x, wih, bih, whh, bhh, dt)
    ref_res = fwd_plain(x, wih, bih, whh, bhh, dt)
    for a, b, r in zip(res, res2, ref_res):
        assert torch.equal(a, b)
        tol = 1e-5 if dt == torch.float32 else 1e-2 * max(1.0, r.float().abs().max().item())
        assert _err(a, r) <= tol
    args = (dout, x, wih, whh) + tuple(ref_res) + (dt,)
    got, again, ref = bwd(*args), bwd(*args), bwd_plain(*args)
    torch.cuda.synchronize()
    assert got[0].shape == (L, rows, 28)
    for name, a, b, r in zip(("dx", "dw_ih", "db_ih", "dw_hh", "db_hh"), got, again, ref):
        assert torch.equal(a, b), name
        assert bool(torch.isfinite(a).all()), name
        assert _err(a, r) <= _grad_tol(name, r, dt), (name, _err(a, r))


@pytest.mark.cuda
@pytest.mark.parametrize("flags", [{}, dict(is_stds=True, is_sn=True, is_map=True)])
@pytest.mark.parametrize("model_type", ["attbigru2s2", "attbilstm2s2"])
def test_full_width_2s2_model_through_k1(model_type, flags):
    """A seeded 3 x 256 2s2 model, 512 sites with wild kinetics (indices
    outside the tables give NaN rows, as in the JAX package): probs through
    K1 against probs through its plain version on the card, fp32 to 1e-5
    (the NaN rows in the same places), and the same model on the CPU."""
    _need_card()
    from ccsmeth_tpu_torch.pipeline.call_mods import build_model

    cfg = AttRNNConfig(model_type=model_type, **flags)
    params = init_attrnn(5, cfg)
    rng = np.random.RandomState(3)
    B = 512
    feats = {}
    for s in ("", "2"):
        feats["kmer" + s] = rng.randint(0, 5, (B, L)).astype(np.float32)
        feats["kpass" + s] = rng.randint(0, 40, (B, 1)).repeat(L, 1).astype(np.float32)
        feats["ipd_means" + s] = (rng.randn(B, L) * 3).astype(np.float32)
        feats["pw_means" + s] = (rng.randn(B, L) * 3).astype(np.float32)
        feats["ipd_stds" + s] = rng.rand(B, L).astype(np.float32)
        feats["pw_stds" + s] = rng.rand(B, L).astype(np.float32)
        feats["sns" + s] = (rng.rand(B, 4) * 10).astype(np.float32)
        feats["maps" + s] = rng.randint(0, 8, (B, L)).astype(np.float32)
    feats["ipd_means"][5, 2] = 2000.0
    card = {k: torch.from_numpy(v).cuda() for k, v in feats.items()}
    model = build_model(params, cfg, "cuda")
    launches = bigru.launches
    with torch.inference_mode():
        _l, p_k = model(card)
        _l, p_p = model(card, rnn_fn=bigru.birnn_stack_plain)
        _l, p_cpu = build_model(params, cfg, "cpu")(
            {k: torch.from_numpy(v) for k, v in feats.items()})
    assert bigru.launches == launches + 1
    nan = torch.isnan(p_k).any(dim=1)
    assert nan.tolist() == [i == 5 for i in range(B)]
    assert torch.equal(nan, torch.isnan(p_p).any(dim=1))
    ok = ~nan
    assert _err(p_k[ok], p_p[ok]) <= 1e-5
    assert _err(p_k[ok].cpu(), p_cpu[ok.cpu()]) <= 1e-5

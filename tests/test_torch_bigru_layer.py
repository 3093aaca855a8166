"""Kernel K2 (one bidirectional GRU or LSTM layer a launch) in the port:
the plain versions of ``birnn_layers`` and ``bigru_layer`` against the JAX
package's per-layer Pallas kernel in interpret mode (``birnn_apply_pallas``,
``bigru_layer_pallas``), h_n rebuilt from the stored outputs, the routing
behind ``rnn_backend='pallas_layer'``, and call_mods on the CPU through it."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ccsmeth_tpu.ops.bigru_pallas import (bigru_layer_pallas, birnn_apply_pallas,
                                         birnn_apply_pallas_stacked)
from ccsmeth_tpu_torch.models import (AttRNN, AttRNNConfig, attrnn_state_dict_from_params,
                                      init_attrnn)
from ccsmeth_tpu_torch.models.rnn import init_rnn_params, layer_weights
from ccsmeth_tpu_torch.ops import bigru
from ccsmeth_tpu_torch.pipeline.call_mods import LAST_RUN, CallModsConfig, call_mods_bam
from tests.test_torch_attrnn import _feats
from tests.test_torch_call_mods import BAM, CKPT, REF, _compare_with_golden, _dump

torch.set_num_threads(1)  # one intra-op thread: the suite runs several workers at once


def _inputs(cell, seed=9, H=32, NL=2, N=10, C=11):
    rng = np.random.RandomState(seed)
    layers = init_rnn_params(rng, C, H, NL, cell)
    x = rng.randn(N, 21, C).astype(np.float32)
    return layers, x


def _port_layers(layers, x, dtype=torch.float32, cell="gru"):
    ly = [layer_weights(ld, dtype) for ld in layers]
    x_tm = torch.from_numpy(x).transpose(0, 1).to(dtype).contiguous()
    return bigru.birnn_layers(ly, x_tm, dtype, cell)


@pytest.mark.parametrize("cell", ["gru", "lstm"])
def test_plain_layers_match_pallas_layer_kernel(cell):
    layers, x = _inputs(cell)
    want_out, want_hn = birnn_apply_pallas(layers, jnp.asarray(x), interpret=True,
                                           cell=cell)
    out, hn = _port_layers(layers, x, cell=cell)
    np.testing.assert_allclose(out.transpose(0, 1).numpy(), np.asarray(want_out),
                               atol=3e-5, rtol=1e-5)
    np.testing.assert_allclose(hn.numpy(), np.asarray(want_hn), atol=3e-5, rtol=1e-5)


@pytest.mark.parametrize("cell", ["gru", "lstm"])
def test_bf16_h_n_is_rebuilt_from_the_stored_outputs(cell):
    """In bf16 h_n is the bf16-rounded output, widened (``bigru_pallas.py:473``),
    where K1's h_n is the f32 state: the two differ by at most one bf16 ulp."""
    layers, x = _inputs(cell, seed=3)
    out, hn = _port_layers(layers, x, torch.bfloat16, cell)
    H = 32
    assert out.dtype == torch.bfloat16 and hn.dtype == torch.float32
    assert torch.equal(hn[2], out[-1, :, :H].float())
    assert torch.equal(hn[3], out[0, :, H:].float())
    ly = [layer_weights(ld, torch.bfloat16) for ld in layers]
    x_tm = torch.from_numpy(x).transpose(0, 1).to(torch.bfloat16).contiguous()
    out1, hn1 = bigru.birnn_stack_plain(ly, x_tm, torch.bfloat16, cell)
    assert torch.equal(out, out1)
    assert (hn - hn1).abs().max().item() <= 2.0 ** -8
    _wo, want_hn = birnn_apply_pallas(layers, jnp.asarray(x), jnp.bfloat16,
                                      interpret=True, cell=cell)
    assert np.abs(hn.numpy() - np.asarray(want_hn)).max() <= 1e-2


# fp32: the same products and gate math in another order of f32 sums; bf16:
# both sides round the same values to bf16, and an f32 sum taken in another
# order moves a rounding by one bf16 ulp (2^-8 on [0.5, 1)), so 8e-3 allows
# two such ulps (as tests/test_torch_bigru.py)
PARITY_TOL = {"float32": dict(atol=3e-5, rtol=1e-5), "bfloat16": dict(atol=8e-3, rtol=0)}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("cell", ["gru", "lstm"])
@pytest.mark.parametrize("entry", ["layers", "stack"])
def test_entries_match_jax_at_ragged_rows(entry, cell, dtype):
    """K2's ``birnn_layers`` against JAX ``birnn_apply_pallas`` and K1's
    ``birnn_stack`` against ``birnn_apply_pallas_stacked``, both Pallas
    kernels in interpret mode, at 13 rows (a ragged last tile of 8) on CPU
    tensors: out and h_n (K2's rebuilt from the outputs on both sides). The
    stack runs its direction-batched chain, which the JAX package's own test
    holds bit-equal to the default one (``test_pallas_bigru.py:92-97``) and
    which interprets in a tenth of the time."""
    layers, x = _inputs(cell, seed=11, H=16, NL=2, N=13)
    dt = getattr(torch, dtype)
    jdt = jnp.float32 if dtype == "float32" else jnp.bfloat16
    ly = [layer_weights(ld, dt) for ld in layers]
    x_tm = torch.from_numpy(x).transpose(0, 1).to(dt).contiguous()
    if entry == "layers":
        out, hn = bigru.birnn_layers(ly, x_tm, dt, cell)
        want_out, want_hn = birnn_apply_pallas(layers, jnp.asarray(x), jdt, b_tile=8,
                                               interpret=True, cell=cell)
    else:
        out, hn = bigru.birnn_stack(ly, x_tm, dt, cell)
        want_out, want_hn = birnn_apply_pallas_stacked(layers, jnp.asarray(x), jdt,
                                                       b_tile=8, interpret=True,
                                                       cell=cell, dir_batched=True)
    assert out.shape == (21, 13, 32) and hn.shape == (4, 13, 16)
    np.testing.assert_allclose(out.transpose(0, 1).float().numpy(),
                               np.asarray(want_out, np.float32), **PARITY_TOL[dtype])
    np.testing.assert_allclose(hn.numpy(), np.asarray(want_hn, np.float32),
                               **PARITY_TOL[dtype])


def test_bigru_layer_matches_bigru_layer_pallas():
    layers, x = _inputs("gru", seed=1, NL=1)
    want = bigru_layer_pallas(layers[0], jnp.asarray(x), interpret=True)
    got = bigru.bigru_layer(layer_weights(layers[0]), torch.from_numpy(x))
    assert got.dtype == torch.float32 and got.shape == (10, 21, 64)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=3e-5, rtol=1e-5)


def test_layer_wrapper_counts_plain_calls_on_cpu():
    layers, x = _inputs("gru")
    k1 = (bigru.launches, bigru.plain_calls)
    k2 = (bigru.layer_launches, bigru.layer_plain_calls)
    out, hn = _port_layers(layers, x)
    assert (bigru.launches, bigru.plain_calls) == k1
    assert (bigru.layer_launches, bigru.layer_plain_calls) == (k2[0], k2[1] + 2)
    ly = [layer_weights(ld) for ld in layers]
    x_tm = torch.from_numpy(x).transpose(0, 1).contiguous()
    out1 = bigru.bigru_layer_tm_plain(ly[0], x_tm)
    assert torch.equal(out1, bigru.bigru_layer_tm(ly[0], x_tm))
    with pytest.raises(ValueError):
        bigru.bigru_layer_tm(ly[1], x_tm)  # layer 1 takes C = 2H


@pytest.mark.parametrize("model_type", ["attbigru2s", "attbilstm2s"])
def test_pallas_layer_backend_routes_the_model_through_k2(model_type):
    """fp32: K2's plain version computes the same products in the same order
    as K1's, so the probs are equal."""
    cfg = AttRNNConfig(model_type=model_type, num_layers=2, hidden_size=32,
                       dropout_rate=0)
    sd = attrnn_state_dict_from_params(init_attrnn(3, cfg))
    feats = {k: torch.from_numpy(v) for k, v in _feats().items()}
    probs = {}
    for backend in ("xla", "pallas_layer"):
        model = AttRNN(cfg, backend)
        model.load_state_dict(sd)
        k2 = bigru.layer_plain_calls
        with torch.inference_mode():
            probs[backend] = model.eval()(feats)[1]
        assert bigru.layer_plain_calls - k2 == (2 if backend == "pallas_layer" else 0)
    assert torch.equal(probs["xla"], probs["pallas_layer"])
    with pytest.raises(ValueError):
        AttRNN(cfg, "cudnn")


def test_call_mods_pallas_layer_runs_k2_plain_version(tmp_path):
    """call_mods --rnn_backend pallas_layer --device cpu on the golden input:
    K2's plain version runs once a layer and batch, K1's never, and the tags
    match tests/goldens/mmml.tsv as the default backend's do."""
    k1 = bigru.plain_calls
    k2 = bigru.layer_plain_calls
    cfg = CallModsConfig(model_file=CKPT, mode="align", ref=REF, batch_size=64,
                         layer_rnn=2, hid_rnn=64, threads=2, no_sort=True,
                         device="cpu", rnn_backend="pallas_layer")
    rows = _dump(call_mods_bam(cfg, BAM, str(tmp_path / "mods")))
    assert bigru.plain_calls == k1
    assert bigru.layer_plain_calls - k2 == 2 * LAST_RUN["batches"] > 0
    _compare_with_golden(rows)

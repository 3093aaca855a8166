"""The port's predict step and wire formats against ccsmeth_tpu's on CPU
(mirrors tests/test_packed_transfer.py)."""

import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from ccsmeth_tpu.models import AttRNNConfig as JaxAttRNNConfig
from ccsmeth_tpu.parallel.mesh import make_predict_fn as jax_make_predict_fn
from ccsmeth_tpu.pipeline.call_mods import _apply_for
from ccsmeth_tpu.utils import wirefmt as jwf
from ccsmeth_tpu_torch.models import (AttRNN, AttRNNConfig,
                                      attrnn_state_dict_from_params, init_attrnn)
from ccsmeth_tpu_torch.parallel.predict import bf16_bits_np, make_predict_fn
from ccsmeth_tpu_torch.utils import wirefmt as pwf
from tests.synth import example_feats

torch.set_num_threads(1)  # one intra-op thread: the suite runs several workers at once

CFG = dict(num_layers=2, hidden_size=32, dropout_rate=0.0)
BF16_ULP = 2.0 ** -8  # one bf16 ulp on [0.5, 1): the bf16 probs fetch


def _feats(B=16, seed=0):
    return example_feats(B, 21, seed, optional="random")


def _pair(seed=1234, **kw):
    """(port predict on CPU, JAX predict) over the same params."""
    params = init_attrnn(seed, AttRNNConfig(**CFG))
    model = AttRNN(AttRNNConfig(**CFG))
    model.load_state_dict(attrnn_state_dict_from_params(params))
    port = make_predict_fn(model.eval(), AttRNNConfig(**CFG), device="cpu", **kw)
    jkw = dict(kw)
    if jkw.pop("transfer_dtype", "fp32") == "bf16":
        jkw["transfer_dtype"] = np.dtype(ml_dtypes.bfloat16)
    jcfg = JaxAttRNNConfig(**CFG)
    jax_p = jax_make_predict_fn(_apply_for(jcfg, "xla", "fp32"), params, jcfg,
                                **jkw)
    return port, jax_p


def test_unpackers_bit_equal_to_jax():
    rng = np.random.RandomState(0)
    raw = rng.randint(0, 256, (64, 11)).astype(np.uint8)
    np.testing.assert_array_equal(
        pwf.unpack_kmer4(torch.from_numpy(raw), 21).numpy(),
        np.asarray(jwf.unpack_kmer4_jx(jnp.asarray(raw), 21)))
    raw16 = rng.randint(0, 256, (64, 2)).astype(np.uint8)
    got = pwf.unpack_u16(torch.from_numpy(raw16)).numpy()
    want = np.asarray(jwf.unpack_u16_jx(jnp.asarray(raw16)))  # (B, 1) uint16
    assert got.shape == want.shape
    np.testing.assert_array_equal(got, want.astype(np.int64))
    q = rng.randint(-128, 128, (64, 21)).astype(np.int8)
    np.testing.assert_array_equal(pwf.dequant_i8(torch.from_numpy(q)).numpy(),
                                  np.asarray(jwf.dequant_i8_jx(jnp.asarray(q))))
    # the numpy packers are the JAX package's, byte for byte
    codes = rng.randint(0, 5, (64, 21))
    np.testing.assert_array_equal(pwf.pack_kmer4_np(codes), jwf.pack_kmer4_np(codes))
    v = rng.uniform(0, 70000, 64)
    np.testing.assert_array_equal(pwf.pack_u16_np(v), jwf.pack_u16_np(v))
    k = rng.randn(64, 21).astype(np.float32) * 4
    np.testing.assert_array_equal(pwf.quant_i8_np(k), jwf.quant_i8_np(k))


def test_bf16_bits_match_ml_dtypes():
    x = np.random.RandomState(1).randn(1000).astype(np.float32) * 3
    np.testing.assert_array_equal(
        bf16_bits_np(x), x.astype(ml_dtypes.bfloat16).view(np.uint16))


@pytest.mark.parametrize("kinetics_quant", ["none", "int8"])
@pytest.mark.parametrize("fetch_mode", ["probs", "mlbyte"])
def test_predict_matches_jax(kinetics_quant, fetch_mode):
    port, jax_p = _pair(kinetics_quant=kinetics_quant, fetch_mode=fetch_mode)
    assert port.row_bytes == jax_p.row_bytes
    feats = _feats(16)
    got = port(feats)
    want = np.asarray(jax_p(feats))
    assert got.dtype == want.dtype and got.shape == want.shape
    if fetch_mode == "mlbyte":
        np.testing.assert_array_equal(got, want)
    elif kinetics_quant == "none":
        np.testing.assert_allclose(got, want, atol=5e-6)
    else:  # the int8 path fetches bf16 probs on both sides
        np.testing.assert_allclose(got, want, atol=BF16_ULP)
    jax_p.close()


def test_bf16_transfer_matches_jax():
    port, jax_p = _pair(transfer_dtype="bf16")
    assert port.row_bytes == jax_p.row_bytes == 198
    feats = _feats(16, seed=2)
    np.testing.assert_allclose(port(feats), np.asarray(jax_p(feats)),
                               atol=BF16_ULP)
    jax_p.close()


def test_dispatch_many_equals_per_batch():
    port, jax_p = _pair()
    jax_p.close()
    fb = [_feats(16, seed=s) for s in range(3)]
    ref = [port(f) for f in fb]
    port.n_batches = 0
    arr = port.collect(port.dispatch_many_async(fb))
    assert arr.shape == (3, 16, 2) and port.n_batches == 3
    for i in range(3):
        np.testing.assert_array_equal(arr[i], ref[i])


def test_fused_dispatcher_partial_group_and_order():
    """The port's _FusedDispatcher groups k batches, does not pad a partial
    group, and resolves tokens in any collect order."""
    from ccsmeth_tpu_torch.pipeline.call_mods import _FusedDispatcher

    port, jax_p = _pair(seed=11)
    jax_p.close()
    fb = [_feats(16, seed=s) for s in range(5)]
    ref = [port(f) for f in fb]
    port.n_batches = 0
    fz = _FusedDispatcher(port, 4)
    toks = [fz.dispatch(f) for f in fb]
    assert _FusedDispatcher.attached(toks[0])
    assert not _FusedDispatcher.attached(toks[4])
    for i in reversed(range(5)):
        np.testing.assert_array_equal(fz.collect(toks[i]), ref[i])
    assert port.n_batches == 5


def test_bad_options_raise():
    model = AttRNN(AttRNNConfig(**CFG))
    with pytest.raises(ValueError):
        make_predict_fn(model, AttRNNConfig(**CFG), "cpu", kinetics_quant="int4")
    with pytest.raises(ValueError):
        make_predict_fn(model, AttRNNConfig(**CFG), "cpu", fetch_mode="u16")

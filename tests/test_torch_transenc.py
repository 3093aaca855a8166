"""transencoder2s in the port against ccsmeth_tpu on the CPU: kernel K3's
plain version (ops/transenc.py) against the Pallas encoder kernel in
interpret mode and the XLA encoder, the SrcEmbed conv stack, the kinetics
lookup, the whole TransEnc forward, and the weights across the packages."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ccsmeth_tpu.models.attrnn import apply_src_embed
from ccsmeth_tpu.models.config import TransEncConfig as JaxTransEncConfig
from ccsmeth_tpu.models.convert import torch_ckpt_to_params as jax_torch_ckpt_to_params
from ccsmeth_tpu.models.transenc import _encoder, apply_transenc
from ccsmeth_tpu.models.transenc import init_transenc as jax_init_transenc
from ccsmeth_tpu.ops.transenc_pallas import encoder_pooled_pallas
from ccsmeth_tpu_torch.models import (TransEnc, TransEncConfig, init_transenc,
                                      torch_ckpt_to_params,
                                      transenc_params_from_state_dict,
                                      transenc_state_dict_from_params)
from ccsmeth_tpu_torch.models.attrnn import SrcEmbed, init_src_embed, take_rows
from ccsmeth_tpu_torch.models.convert import _src_embed_sd
from ccsmeth_tpu_torch.models.params_io import _flatten
from ccsmeth_tpu_torch.models.transenc import randomize_affine
from ccsmeth_tpu_torch.ops import transenc
from tests.synth import example_feats
from tests.test_torch_call_mods import BAM, REF

torch.set_num_threads(1)  # one intra-op thread: the suite runs several workers at once

SMALL = dict(num_layers=2, d_model=64, nhead=4, dim_ff=128, dropout_rate=0.0)
ALL_OPTIONS = dict(SMALL, is_stds=True, is_sn=True, is_map=True)


def _port_model(params, cfg):
    m = TransEnc(cfg)
    m.load_state_dict(transenc_state_dict_from_params(params))
    return m.eval()


def _port_forward(model, feats, **kw):
    with torch.inference_mode():
        logits, probs = model({k: torch.from_numpy(np.asarray(v)) for k, v in feats.items()},
                              **kw)
    return logits.numpy(), probs.numpy()


def _golden_feats(n=120):
    """The first n CpG sites of tests/goldens/reads.bam, extracted by the
    port (align mode, zscore)."""
    from ccsmeth_tpu_torch.bamio import BamReader
    from ccsmeth_tpu_torch.features import (ExtractConfig, batch_from_reads,
                                            extract_read_features)
    from ccsmeth_tpu_torch.utils.codecs import get_motif_seqs
    from ccsmeth_tpu_torch.utils.fasta import DNAReference

    reader = BamReader(BAM)
    names = [r[0] for r in reader.header.references]
    contigs = DNAReference(REF).getcontigs()
    reads = [extract_read_features(rec, get_motif_seqs("CG"), ExtractConfig(mode="align"),
                                   contigs, None, None,
                                   names[rec.ref_id] if rec.ref_id >= 0 else None)
             for rec in reader]
    reader.close()
    feats = batch_from_reads([r for r in reads if r is not None]).model_feats()
    return {k: np.ascontiguousarray(v[:n]) for k, v in feats.items()}


@pytest.mark.parametrize("cfg_kw", [SMALL, ALL_OPTIONS, {}])
def test_init_transenc_equals_jax_init(cfg_kw):
    p = dict(_flatten(init_transenc(3, TransEncConfig(**cfg_kw))))
    q = dict(_flatten(jax_init_transenc(3, JaxTransEncConfig(**cfg_kw))))
    assert p.keys() == q.keys()
    for k in p:
        np.testing.assert_array_equal(p[k], np.asarray(q[k]), err_msg=k)


@pytest.mark.parametrize("reference", ["pallas", "xla"])
def test_encoder_plain_matches_jax(reference):
    """N = 50: a ragged tile for the Pallas kernel (48 samples a tile) and for
    K3 (2 or 3 a block); random biases and LayerNorm parameters. Tolerance as
    tests/test_transenc_pallas.py."""
    cfg = JaxTransEncConfig(**SMALL)
    params = randomize_affine(init_transenc(5, TransEncConfig(**SMALL)), 5)
    x = np.random.RandomState(4).randn(50, 21, 64).astype(np.float32) * 0.4
    if reference == "pallas":
        want = encoder_pooled_pallas(params, cfg, jnp.asarray(x), interpret=True)
    else:
        want = jnp.mean(_encoder(params, cfg, jnp.asarray(x), None, False), axis=1)
    st = transenc.stack_layers(params["layers"])
    got = transenc.encoder_pooled_plain(st, torch.from_numpy(x), torch.float32, 4)
    assert got.dtype == torch.float32 and got.shape == (50, 64)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5, rtol=1e-4)


def test_encoder_wrapper_takes_the_plain_version_for_cpu_tensors():
    params = init_transenc(5, TransEncConfig(**SMALL))
    st = transenc.stack_layers(params["layers"])
    x = torch.from_numpy(np.random.RandomState(1).randn(7, 21, 64).astype(np.float32))
    launches, plain = transenc.launches, transenc.plain_calls
    got = transenc.encoder_pooled(st, x, torch.float32, 4)
    assert (transenc.launches, transenc.plain_calls) == (launches, plain + 1)
    assert torch.equal(got, transenc.encoder_pooled_plain(st, x, torch.float32, 4))
    with pytest.raises(TypeError):
        transenc.encoder_pooled(st, x.to(torch.bfloat16), torch.float32, 4)
    with pytest.raises(ValueError):  # bf16 operands with f32 weights
        transenc.encoder_pooled(st, x.to(torch.bfloat16), torch.bfloat16, 4)
    with pytest.raises(ValueError):
        transenc.encoder_pooled(st, x, torch.float32, 5)  # 64 % 5 != 0


def test_encoder_flops_and_tile_shape():
    assert transenc.encoder_flops(1, 21, 256, 512, 6) == 134_830_080
    assert transenc.tile_shape(21, 256, 512) == (2, 6, 50)
    S, R, ld = transenc.tile_shape(21, 64, 128)
    assert S * 21 <= 8 * R <= ld


@pytest.mark.parametrize("cin,d_model,block_plus", [(28, 64, 1), (4, 4, 0)])
def test_src_embed_matches_apply_src_embed(cin, d_model, block_plus):
    """Random non-trivial BatchNorm running stats, scale and bias."""
    rng = np.random.RandomState(cin)
    p = init_src_embed(rng, cin, d_model, block_plus)
    for bn in [p["bn1"], p["bn2"]] + [b["bn"] for b in p["plus"]]:
        c = bn["scale"].shape[0]
        bn["scale"] = rng.uniform(0.5, 1.5, c).astype(np.float32)
        bn["bias"] = rng.randn(c).astype(np.float32) * 0.2
        bn["mean"] = rng.randn(c).astype(np.float32) * 0.1
        bn["var"] = rng.uniform(0.5, 2.0, c).astype(np.float32)
    sd = {}
    _src_embed_sd(p, "m", sd)
    mod = SrcEmbed(cin, d_model, block_plus)
    mod.load_state_dict({k[2:]: v for k, v in sd.items()})
    x = rng.randn(9, 21, cin).astype(np.float32)
    with torch.inference_mode():
        got = mod(torch.from_numpy(x)).numpy()
    want = np.asarray(apply_src_embed(p, jnp.asarray(x)))
    assert got.shape == (9, 21, d_model)
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-5)


def test_take_rows_is_jnp_take_on_truncated_floats():
    """Truncation toward zero, negative indices wrapped, NaN rows outside
    [-n, n)."""
    table = np.random.RandomState(0).randn(953, 8).astype(np.float32)
    idx = np.array([[0.0, 0.9, -0.9, -1.0, -1.5, 951.7, 952.9, 953.0, -952.5,
                     -953.0, -953.2, 1e4, 2.5, -954.0]], np.float32)
    got = take_rows(torch.from_numpy(table), torch.from_numpy(idx)).numpy()
    want = np.asarray(jnp.take(jnp.asarray(table), jnp.asarray(idx).astype(jnp.int32),
                               axis=0))
    assert got.shape == want.shape == (1, 14, 8)
    np.testing.assert_array_equal(got, want)
    nan_rows = np.isnan(got[0]).all(axis=1)
    assert np.flatnonzero(nan_rows).tolist() == [7, 11, 13]
    np.testing.assert_array_equal(got[0, 3], table[952])  # -1 wraps


@pytest.mark.parametrize("backend", ["xla", "pallas"])
@pytest.mark.parametrize("feats_from", ["random", "reads.bam"])
def test_forward_matches_apply_transenc(backend, feats_from):
    """'pallas' runs the JAX package's fused encoder in interpret mode.
    Random biases, LayerNorm and BatchNorm parameters."""
    params = randomize_affine(init_transenc(7, TransEncConfig(**SMALL)), 7)
    feats = example_feats(13, seed=2) if feats_from == "random" else _golden_feats()
    l_t, p_t = _port_forward(_port_model(params, TransEncConfig(**SMALL)), feats)
    l_j, p_j = apply_transenc(params, JaxTransEncConfig(**SMALL), feats, backend=backend)
    assert np.isfinite(l_t).all()
    np.testing.assert_allclose(l_t, np.asarray(l_j), atol=1e-5)
    np.testing.assert_allclose(p_t, np.asarray(p_j), atol=1e-5)


def test_forward_with_every_option_matches_apply_transenc():
    """stds, sn and map channels on: the two std SrcEmbeds, the sn SrcEmbed
    without a plus block, and the map embedding."""
    params = randomize_affine(init_transenc(8, TransEncConfig(**ALL_OPTIONS)), 8)
    feats = example_feats(11, seed=3, optional="random")
    l_t, _ = _port_forward(_port_model(params, TransEncConfig(**ALL_OPTIONS)), feats)
    l_j, _ = apply_transenc(params, JaxTransEncConfig(**ALL_OPTIONS), feats)
    np.testing.assert_allclose(l_t, np.asarray(l_j), atol=1e-5)


def test_out_of_range_kinetics_give_nan_where_jax_does():
    feats = example_feats(6, seed=5)
    feats["ipd_means"][1, 3] = 2000.0   # past the table: NaN row
    feats["pw_means2"][4, 0] = -960.0   # below -n: NaN row
    feats["ipd_means"][2, 5] = -3.7     # wraps to row 950
    params = init_transenc(9, TransEncConfig(**SMALL))
    l_t, _ = _port_forward(_port_model(params, TransEncConfig(**SMALL)), feats)
    l_j, _ = apply_transenc(params, JaxTransEncConfig(**SMALL), feats)
    assert np.isnan(l_t[[1, 4]]).all() and np.isfinite(l_t[[0, 2, 3, 5]]).all()
    np.testing.assert_allclose(l_t, np.asarray(l_j), atol=1e-5, equal_nan=True)


def test_bf16_forward_stays_near_fp32():
    """bf16 encoder operands (the input cast first, as the JAX fast path)."""
    params = randomize_affine(init_transenc(7, TransEncConfig(**SMALL)), 7)
    model = _port_model(params, TransEncConfig(**SMALL))
    feats = example_feats(13, seed=2)
    _l, p32 = _port_forward(model, feats)
    _l, p16 = _port_forward(model, feats, compute_dtype=torch.bfloat16)
    _l, pj = apply_transenc(params, JaxTransEncConfig(**SMALL), feats,
                            compute_dtype=jnp.bfloat16, backend="pallas")
    assert np.abs(p16 - p32).max() < 2.0 / 256
    assert np.abs(p16 - np.asarray(pj)).max() < 2.0 / 256


def test_params_state_dict_round_trip():
    cfg = TransEncConfig(**ALL_OPTIONS)
    params = randomize_affine(init_transenc(4, cfg), 4)
    sd = transenc_state_dict_from_params(params)
    assert set(sd) == set(TransEnc(cfg).state_dict())
    back = dict(_flatten(transenc_params_from_state_dict(sd, cfg)))
    want = dict(_flatten(params))
    assert back.keys() == want.keys()
    for k in want:
        np.testing.assert_array_equal(back[k], want[k], err_msg=k)


def test_reference_named_checkpoint_loads_in_both_packages(tmp_path):
    """A state_dict under the reference's names (DDP 'module.' prefix and
    BatchNorm counters included), saved with torch.save, converts to the same
    params in both packages."""
    cfg = TransEncConfig(**SMALL)
    model = _port_model(randomize_affine(init_transenc(6, cfg), 6), cfg)
    path = str(tmp_path / "transenc.ckpt")
    torch.save({"module." + k: v for k, v in model.state_dict().items()}, path)
    got = dict(_flatten(torch_ckpt_to_params(path, cfg)))
    want = dict(_flatten(jax_torch_ckpt_to_params(path, JaxTransEncConfig(**SMALL))))
    assert got.keys() == want.keys()
    for k in want:
        np.testing.assert_array_equal(got[k], np.asarray(want[k]), err_msg=k)


def test_randomize_affine_sets_every_trivial_operand():
    """Every bias and LayerNorm / BatchNorm parameter that init_transenc
    leaves 0 or 1 becomes random, different per layer; the weights stay."""
    params = init_transenc(3, TransEncConfig(**SMALL))
    rnd = randomize_affine(params, 3)
    a, b = dict(_flatten(params)), dict(_flatten(rnd))
    assert a.keys() == b.keys()
    changed = {k for k in a if not np.array_equal(a[k], b[k])}
    trivial = {k for k in a if np.all(a[k] == 0) or np.all(a[k] == 1)}
    assert changed == trivial and len(changed) == 2 * 8 + 3 * 4 + 2
    l0, l1 = rnd["layers"]
    for k in ("bq", "bk", "bv", "bo"):
        assert not np.array_equal(l0[k], l1[k])
    assert not np.array_equal(l0["ln1"]["scale"], l1["ln1"]["scale"])


def test_stacked_weights_are_built_once_per_parameter_state():
    """TransEnc reuses the kernel layout across inference batches and makes
    a new one when a parameter changes or gradients are recorded."""
    cfg = TransEncConfig(**SMALL)
    model = _port_model(randomize_affine(init_transenc(2, cfg), 2), cfg)
    with torch.inference_mode():
        first = model.stacked()
        assert model.stacked() is first
        assert model.stacked(torch.bfloat16) is not first
        assert model.stacked(torch.bfloat16)["wqkv"].dtype == torch.bfloat16
    params = randomize_affine(init_transenc(2, cfg), 3)
    model.load_state_dict(transenc_state_dict_from_params(params))
    with torch.inference_mode():
        again = model.stacked()
    assert again is not first
    want = transenc.stack_layers(params["layers"])
    for k in want:
        assert torch.equal(again[k], want[k]), k
    assert model.stacked()["wqkv"].requires_grad

"""attbigru2s2 and attbilstm2s2, the embedded-kinetics families: the port's
AttRNN against ccsmeth_tpu's init_attrnn and apply_attrnn on the same params
and numpy feats, on CPU; checkpoints both ways; call_mods on
tests/goldens/reads.bam and tests/goldens/features.tsv against the JAX
package's call_mods."""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ccsmeth_tpu.models import AttRNNConfig as JaxAttRNNConfig
from ccsmeth_tpu.models import apply_attrnn
from ccsmeth_tpu.models import init_attrnn as jax_init_attrnn
from ccsmeth_tpu.models.convert import _attrnn_from_sd
from ccsmeth_tpu.models.params_io import load_params as jax_load_params
from ccsmeth_tpu.models.params_io import save_params as jax_save_params
from ccsmeth_tpu_torch.bamio import BamReader
from ccsmeth_tpu_torch.models import (AttRNN, AttRNNConfig, attrnn_params_from_state_dict,
                                      attrnn_state_dict_from_params, init_attrnn)
from ccsmeth_tpu_torch.models.attrnn import rnn_input_size
from ccsmeth_tpu_torch.models.convert import torch_ckpt_to_params
from ccsmeth_tpu_torch.models.params_io import _flatten, load_params, save_params
from ccsmeth_tpu_torch.ops import bigru

torch.set_num_threads(1)  # one intra-op thread: the suite runs several workers at once

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GOLD = os.path.join(REPO, "tests", "goldens")
BAM = os.path.join(GOLD, "reads.bam")
REF = os.path.join(GOLD, "ref.fa")
TSV = os.path.join(GOLD, "features.tsv")

SMALL = dict(num_layers=2, hidden_size=16, dropout_rate=0)
FLAGS = {"default": {}, "stds_sn_map": dict(is_stds=True, is_sn=True, is_map=True)}
FAMILIES = ["attbigru2s2", "attbilstm2s2"]


def _cfg_kw(model_type, flags, **kw):
    return dict(SMALL, model_type=model_type, **FLAGS[flags], **kw)


def _feats(B=12, L=21, seed=4, wild=False):
    """Numpy feats of every channel. ``wild`` puts kinetics far outside the
    tables (>= 953 and < -953: NaN rows in both packages), negative ones
    (the last rows of the table), kpass outside [1, 30] (clipped) and
    fractional values (truncated toward zero) into the means."""
    rng = np.random.RandomState(seed)
    feats = {}
    for s in ("", "2"):
        feats["kmer" + s] = rng.randint(0, 5, (B, L)).astype(np.float32)
        feats["kpass" + s] = rng.randint(0, 40, (B, 1)).repeat(L, 1).astype(np.float32)
        feats["ipd_means" + s] = (rng.randn(B, L) * 3).astype(np.float32)
        feats["pw_means" + s] = (rng.randn(B, L) * 3).astype(np.float32)
        feats["ipd_stds" + s] = rng.randn(B, L).astype(np.float32)
        feats["pw_stds" + s] = rng.randn(B, L).astype(np.float32)
        feats["sns" + s] = (rng.rand(B, 4) * 10).astype(np.float32)
        feats["maps" + s] = rng.randint(0, 8, (B, L)).astype(np.float32)
    if wild:
        feats["ipd_means"][0, 3] = 953.0
        feats["pw_means2"][1, 7] = -954.5
        feats["ipd_means"][2, :] = np.linspace(-952.9, 952.9, L)
        feats["pw_means"][3, :] = np.linspace(-2.9, 2.9, L)
        feats["maps"][4, 5] = -3.0
    return feats


def _port_model(params, cfg, rnn_backend="xla"):
    m = AttRNN(cfg, rnn_backend)
    m.load_state_dict(attrnn_state_dict_from_params(params))
    return m.eval()


def _port_forward(model, feats, **kw):
    with torch.inference_mode():
        logits, probs = model({k: torch.from_numpy(v) for k, v in feats.items()}, **kw)
    return logits.numpy(), probs.numpy()


def _random_bn(params, seed):
    """Seeded BatchNorm scales, biases and running stats in every SrcEmbed
    (init leaves them 1 and 0, which would hide a mixed-up operand)."""
    rng = np.random.RandomState(seed)
    for name in ("ipd_std_embed", "pw_std_embed", "sn_embed"):
        if name not in params:
            continue
        se = params[name]
        for bn in [se["bn1"], se["bn2"]] + [b["bn"] for b in se["plus"]]:
            c = bn["scale"].shape[0]
            bn.update(scale=rng.uniform(0.5, 1.5, c).astype(np.float32),
                      bias=(rng.randn(c) * 0.2).astype(np.float32),
                      mean=(rng.randn(c) * 0.1).astype(np.float32),
                      var=rng.uniform(0.5, 2.0, c).astype(np.float32))
    return params


@pytest.mark.parametrize("flags", list(FLAGS))
@pytest.mark.parametrize("model_type", FAMILIES)
def test_init_attrnn_equals_jax_init(model_type, flags):
    kw = _cfg_kw(model_type, flags)
    p = dict(_flatten(init_attrnn(3, AttRNNConfig(**kw))))
    q = dict(_flatten(jax_init_attrnn(3, JaxAttRNNConfig(**kw))))
    assert p.keys() == q.keys()
    for k in p:
        np.testing.assert_array_equal(p[k], np.asarray(q[k]), err_msg=k)
    want_c = 52 if flags == "stds_sn_map" else 28
    assert rnn_input_size(AttRNNConfig(**kw)) == want_c
    assert p["rnn/0/fwd/w_ih"].shape[1] == want_c
    assert rnn_input_size(AttRNNConfig(model_type=model_type)) == 28


@pytest.mark.parametrize("rnn_backend", ["xla", "pallas_layer"])
@pytest.mark.parametrize("flags", list(FLAGS))
@pytest.mark.parametrize("model_type", FAMILIES)
def test_forward_matches_apply_attrnn(model_type, flags, rnn_backend):
    """The port's forward through K1's plain version (xla) or K2's
    (pallas_layer) against apply_attrnn's default path, with wild kinetics:
    NaN rows for indices outside the tables, as jnp.take gives."""
    kw = _cfg_kw(model_type, flags)
    params = _random_bn(init_attrnn(3, AttRNNConfig(**kw)), 9)
    feats = _feats(wild=True)
    counts = (bigru.plain_calls, bigru.layer_plain_calls)
    l_t, p_t = _port_forward(_port_model(params, AttRNNConfig(**kw), rnn_backend), feats)
    if rnn_backend == "xla":
        assert bigru.plain_calls == counts[0] + 1
    else:
        assert bigru.layer_plain_calls == counts[1] + SMALL["num_layers"]
    l_j, p_j = apply_attrnn(params, JaxAttRNNConfig(**kw), feats)
    l_j, p_j = np.asarray(l_j), np.asarray(p_j)
    nan_rows = np.isnan(l_j).any(axis=1)
    assert nan_rows[[0, 1]].all() and not nan_rows[2:].any()
    np.testing.assert_array_equal(np.isnan(l_t), np.isnan(l_j))
    np.testing.assert_allclose(l_t, l_j, atol=5e-5, rtol=1e-4)
    np.testing.assert_allclose(p_t, p_j, atol=5e-6)


@pytest.mark.parametrize("model_type,flags,dtype", [
    ("attbigru2s2", "default", "float32"), ("attbilstm2s2", "default", "float32"),
    ("attbigru2s2", "stds_sn_map", "bfloat16"), ("attbilstm2s2", "default", "bfloat16")])
def test_forward_matches_the_pallas_stack_kernel(model_type, flags, dtype):
    """apply_attrnn with rnn_backend 'pallas' runs the JAX package's stack
    kernel (K1's TPU original) in interpret mode at the embedded input's
    width (C = 28 or 52), here at L = 11 and one layer to keep interpret mode
    short. float32: the tolerances above. bfloat16 operands in both (the
    feats at the same transfer precision, float32 here): probs within the
    bf16 envelope of 2/256."""
    kw = _cfg_kw(model_type, flags, seq_len=11, num_layers=1)
    params = init_attrnn(5, AttRNNConfig(**kw))
    feats = _feats(B=8, L=11, seed=6)
    dt = getattr(torch, dtype)
    l_t, p_t = _port_forward(_port_model(params, AttRNNConfig(**kw)), feats,
                             compute_dtype=dt)
    l_j, p_j = apply_attrnn(params, JaxAttRNNConfig(**kw), feats, rnn_backend="pallas",
                            compute_dtype=getattr(jnp, dtype))
    if dtype == "float32":
        np.testing.assert_allclose(l_t, np.asarray(l_j), atol=5e-5, rtol=1e-4)
        np.testing.assert_allclose(p_t, np.asarray(p_j), atol=5e-6)
    else:
        assert np.abs(p_t - np.asarray(p_j)).max() < 2.0 / 256


@pytest.mark.parametrize("flags", list(FLAGS))
@pytest.mark.parametrize("model_type", FAMILIES)
def test_checkpoints_round_trip(model_type, flags, tmp_path):
    """state_dict -> params -> state_dict; the port's npz read by the JAX
    package and the JAX package's npz read by the port; a reference-layout
    .ckpt (DDP 'module.' prefix) through both packages' converters."""
    kw = _cfg_kw(model_type, flags)
    cfg = AttRNNConfig(**kw)
    params = _random_bn(init_attrnn(11, cfg), 3)
    model = _port_model(params, cfg)
    sd = model.state_dict()
    back = attrnn_state_dict_from_params(attrnn_params_from_state_dict(sd))
    assert back.keys() == sd.keys()
    for k in sd:
        assert torch.equal(back[k].to(sd[k].dtype), sd[k]), k
    want = dict(_flatten(params))

    def same(got):
        got = dict(_flatten(got))
        assert got.keys() == want.keys()
        for k in got:
            np.testing.assert_array_equal(np.asarray(got[k]), want[k], err_msg=k)

    port_npz, jax_npz = str(tmp_path / "port.ckpt.npz"), str(tmp_path / "jax.ckpt.npz")
    save_params(port_npz, attrnn_params_from_state_dict(sd))
    same(jax_load_params(port_npz))
    jax_save_params(jax_npz, params)
    same(load_params(jax_npz))
    ckpt = str(tmp_path / "m.ckpt")
    torch.save({"module." + k: v for k, v in sd.items()}, ckpt)
    same(torch_ckpt_to_params(ckpt, cfg))
    np_sd = {k: v.numpy() for k, v in sd.items()}
    same(_attrnn_from_sd(np_sd, JaxAttRNNConfig(**kw)))


def _spread(params):
    """A random small model gives nearly one ML byte everywhere; the tables
    x10 and the classifier's output layer x100 spread its calls over most
    of 0-255, so that equal tags say something."""
    for name in ("seq_embed", "ipd_embed", "pw_embed"):
        params[name] = params[name] * 10
    params["classifier"][1]["w"] = params["classifier"][1]["w"] * 100
    return params


def _dump(modbam):
    rows = []
    for rec in BamReader(modbam):
        rows.append((rec.qname, rec.get_tag("MM") if rec.has_tag("MM") else ".",
                     np.asarray(rec.get_tag("ML"), np.int64) if rec.has_tag("ML")
                     else None))
    return rows


@pytest.mark.parametrize("model_type,flags", [(m, "default") for m in FAMILIES]
                         + [("attbigru2s2", "stds_sn_map")])
def test_call_mods_bam_matches_jax(model_type, flags, tmp_path, monkeypatch):
    """The slice as a whole on tests/goldens/reads.bam with a seeded 2 x 16
    2s2 checkpoint: the JAX package's call_mods_bam and the port's on the
    CPU; with stds, sn and map on (C = 52) the extracted channels reach the
    embedded input, and the model travels as a reference-layout .ckpt (see
    the TSV test). MM strings and read order are equal; ML bytes are equal,
    except that one may differ by 1 where the port's 6-decimal prob lies
    within 1e-5 of the 1/256 boundary between the two (the JAX run shards
    over 8 virtual devices, which moves the last ulp of a prob)."""
    from ccsmeth_tpu.pipeline.call_mods import CallModsConfig as JaxCallModsConfig
    from ccsmeth_tpu.pipeline.call_mods import call_mods_bam as jax_call_mods_bam
    from ccsmeth_tpu_torch.pipeline import call_mods as port

    cfg_kw = _cfg_kw(model_type, flags)
    params = _spread(_random_bn(init_attrnn(17, AttRNNConfig(**cfg_kw)), 5))
    ckpt = str(tmp_path / "m.ckpt")
    torch.save(_port_model(params, AttRNNConfig(**cfg_kw)).state_dict(), ckpt)
    kw = dict(model_file=ckpt, model_type=model_type, mode="align", ref=REF,
              batch_size=64, layer_rnn=2, hid_rnn=16, threads=2, no_sort=True,
              **FLAGS[flags])
    want = _dump(jax_call_mods_bam(JaxCallModsConfig(**kw), BAM, str(tmp_path / "jax")))
    probs = {}
    tag = port.add_mm_ml_to_record

    def recording_tag(rec, locs_probs, rm_pulse=True):
        probs[rec.qname] = [p for _loc, p in sorted(locs_probs)]
        return tag(rec, locs_probs, rm_pulse)

    monkeypatch.setattr(port, "add_mm_ml_to_record", recording_tag)
    got = _dump(port.call_mods_bam(port.CallModsConfig(**kw, device="cpu"), BAM,
                                   str(tmp_path / "port")))
    assert [r[:2] for r in got] == [w[:2] for w in want]
    n_sites = 0
    for (q, _mm, a), (_q, _wmm, b) in zip(got, want):
        assert (a is None) == (b is None)
        if a is None:
            continue
        n_sites += a.size
        for i in np.flatnonzero(a != b):
            assert abs(a[i] - b[i]) == 1, (q, i, a[i], b[i])
            assert abs(probs[q][i] - max(a[i], b[i]) / 256.0) <= 1e-5
    assert n_sites > 500
    assert len({int(x) for _q, _m, a in got if a is not None for x in a}) > 40


@pytest.mark.parametrize("model_type", FAMILIES)
def test_call_mods_tsv_matches_jax(model_type, tmp_path):
    """call_mods on tests/goldens/features.tsv, its empty stds, sn and map
    columns filled with seeded values, with a seeded 2s2 model under
    --is_stds/--is_sn/--is_map yes (those columns reach the embedded input;
    C = 52), the port on the CPU against the JAX
    package's call_mods_txt: every field equal but the printed probs, which
    agree to two units of the 6th decimal (the float32 rounding of another
    order of sums, the JAX run's 8 virtual devices and its conv among them,
    magnified by ``_spread``'s x100 output layer; one row of 729 differs by
    2e-6 for the GRU).
    The model travels as a reference-layout .ckpt: the JAX package cannot
    run an --is_sn model loaded from a .npz, which keeps no key for
    sn_embed's empty block list; the port loads both (checked here)."""
    from ccsmeth_tpu.pipeline.call_mods import CallModsConfig as JaxCallModsConfig
    from ccsmeth_tpu.pipeline.call_mods import call_mods_txt as jax_call_mods_txt
    from ccsmeth_tpu_torch.pipeline import call_mods as port

    cfg_kw = _cfg_kw(model_type, "stds_sn_map")
    params = _spread(_random_bn(init_attrnn(19, AttRNNConfig(**cfg_kw)), 6))
    ckpt, npz = str(tmp_path / "m.ckpt"), str(tmp_path / "m.ckpt.npz")
    torch.save(_port_model(params, AttRNNConfig(**cfg_kw)).state_dict(), ckpt)
    save_params(npz, params)
    kw = dict(model_type=model_type, batch_size=64, layer_rnn=2, hid_rnn=16,
              is_stds=True, is_sn=True, is_map=True)
    tsv = str(tmp_path / "features.tsv")
    rng = np.random.RandomState(8)
    with open(TSV) as f, open(tsv, "w") as out:
        for line in f:
            w = line.rstrip("\n").split("\t")
            n = len(w[5])
            for i in (8, 10, 16, 18):  # the stds of both strands
                w[i] = ",".join("{:.6f}".format(v) for v in rng.rand(n))
            for i in (11, 19):  # the sn
                w[i] = ",".join("{:.4f}".format(v) for v in rng.rand(4) * 20)
            for i in (12, 20):  # the map
                w[i] = ",".join(str(v) for v in rng.randint(0, 8, n))
            out.write("\t".join(w) + "\n")
    with open(jax_call_mods_txt(JaxCallModsConfig(model_file=ckpt, **kw), tsv,
                                str(tmp_path / "jax"))) as f:
        want = [ln.rstrip("\n").split("\t") for ln in f]
    for model_file in (ckpt, npz):
        with open(port.call_mods_txt(port.CallModsConfig(
                model_file=model_file, **kw, device="cpu"), tsv, str(tmp_path / "port"))) as f:
            got = [ln.rstrip("\n").split("\t") for ln in f]
        assert len(got) == len(want) == 729
        for a, b in zip(got, want):
            assert a[:6] + a[8:] == b[:6] + b[8:]
            assert abs(float(a[6]) - float(b[6])) <= 2.01e-6
            assert abs(float(a[7]) - float(b[7])) <= 2.01e-6
        assert len({r[7] for r in got}) > 50


def test_unported_and_mismatched_requests_raise(tmp_path):
    """The attbi*1s families stay unported; a 2s2 checkpoint without its
    stds embeds under --is_stds yes is a shape mismatch."""
    from ccsmeth_tpu_torch.pipeline.call_mods import CallModsConfig, call_mods_bam

    with pytest.raises(NotImplementedError):
        AttRNN(AttRNNConfig(model_type="attbigru1s"))
    with pytest.raises(NotImplementedError):
        init_attrnn(0, AttRNNConfig(model_type="attbilstm1s"))
    ckpt = str(tmp_path / "m.ckpt.npz")
    save_params(ckpt, init_attrnn(1, AttRNNConfig(**_cfg_kw("attbigru2s2", "default"))))
    cfg = CallModsConfig(model_file=ckpt, model_type="attbigru2s2", mode="align",
                         ref=REF, layer_rnn=2, hid_rnn=16, is_stds=True, device="cpu")
    with pytest.raises(ValueError, match="ipd_std_embed"):
        call_mods_bam(cfg, BAM, str(tmp_path / "x"))

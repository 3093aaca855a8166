"""transencoder2s as a torch nn.Module (inference).

Counterpart of ``ccsmeth_tpu/models/transenc.py`` (``apply_transenc :178``):
  - per strand, the kmer, IPD and PW embeddings (and npass, stds, sn, map
    where the config enables them) go through the ``trans_input`` SrcEmbed
    conv stack, and the learned position embedding is added
    (``_embed_strand_input :141-175``);
  - both strands, concatenated on the batch axis, go through ONE call of the
    encoder stack + mean over positions: kernel K3 (``ops/transenc.py``) on
    CUDA, its plain version on the CPU (``:187-204``); with bf16 operands the
    encoder input is cast to bf16 first (``:197-201``);
  - the two pooled halves are concatenated and go through Linear, ReLU,
    Linear and softmax (``:210-216``).

The kinetics lookups reproduce ``jnp.take`` on ``astype(int32)`` of the
feature floats (``:151-153``) exactly, as ``attrnn.take_rows`` says: call_mods feeds
z-score-normalised means, often small and negative.

Attribute names are the reference state_dict keys that the JAX package's
``_transenc_from_sd`` reads (``ccsmeth_tpu/models/convert.py:119-154``):
``seq_embed``, ``ipd_embed``, ``pw_embed``, ``npass_embed``, ``trans_input``,
``pos_encoder.pos_embed``, ``transformer_encoder.layers.{i}.self_attn.
{in_proj_weight, in_proj_bias, out_proj}``, ``linear1``, ``linear2``,
``norm1``, ``norm2``, ``classifier.0`` and ``classifier.3``. The encoder
modules only hold parameters: the forward never runs them as torch layers.
Training is not ported (``train --model_type transencoder2s`` raises).
"""

from __future__ import annotations

import copy
import math

import numpy as np
import torch
from torch import nn

from ..ops import transenc
from ..utils.constants import (MAX_KINETICS, MAX_MAP, MAX_PASSES, NEMBED_BASE,
                               NEMBED_KINETICS, NEMBED_KINETICS_STD, NEMBED_MAP,
                               NEMBED_PASSES, NEMBED_SN, N_VOCAB)
from .attrnn import (SrcEmbed, _lin_init, add_kinetics_embeds, init_src_embed,
                     kinetics_embedded, kinetics_width)
from .config import TransEncConfig


def init_transenc(seed, cfg: TransEncConfig) -> dict:
    """numpy params pytree with the same draws, in the same order, as
    ``ccsmeth_tpu``'s init_transenc (``transenc.py:32-81``). ``seed`` may be
    an int or an rng-like object (a shape-only probe for checkpoint shape
    checks)."""
    rng = seed if hasattr(seed, "uniform") else np.random.RandomState(seed)
    d = cfg.d_model
    nembed_all = NEMBED_BASE + 2 * NEMBED_KINETICS
    params: dict = {
        "seq_embed": rng.uniform(-0.1, 0.1, (N_VOCAB, NEMBED_BASE)).astype(np.float32),
        "ipd_embed": rng.uniform(-0.1, 0.1, (MAX_KINETICS + 1, NEMBED_KINETICS)).astype(np.float32),
        "pw_embed": rng.uniform(-0.1, 0.1, (MAX_KINETICS + 1, NEMBED_KINETICS)).astype(np.float32),
        "pos_embed": rng.normal(0, 1, (cfg.seq_len, d)).astype(np.float32),
        "classifier": [
            _lin_init(rng, d * 2, d * 2, initrange=0.1),
            _lin_init(rng, d * 2, cfg.num_classes, initrange=0.1),
        ],
        "layers": [],
    }
    if cfg.is_npass:
        params["npass_embed"] = rng.uniform(-0.1, 0.1, (MAX_PASSES + 1, NEMBED_PASSES)).astype(np.float32)
        nembed_all += NEMBED_PASSES
    if cfg.is_stds:
        params["ipd_std_embed"] = init_src_embed(rng, 1, NEMBED_KINETICS_STD, 1)
        params["pw_std_embed"] = init_src_embed(rng, 1, NEMBED_KINETICS_STD, 1)
        nembed_all += 2 * NEMBED_KINETICS_STD
    if cfg.is_sn:
        params["sn_embed"] = init_src_embed(rng, 4, NEMBED_SN, 0)
        nembed_all += NEMBED_SN
    if cfg.is_map:
        params["map_embed"] = rng.uniform(-0.1, 0.1, (MAX_MAP, NEMBED_MAP)).astype(np.float32)
        nembed_all += NEMBED_MAP
    params["trans_input"] = init_src_embed(rng, nembed_all, d, 1)

    def lin(fi, fo):
        k = 1.0 / math.sqrt(fi)
        return {"w": rng.uniform(-k, k, (fi, fo)).astype(np.float32),
                "b": rng.uniform(-k, k, (fo,)).astype(np.float32)}

    for _ in range(cfg.num_layers):
        lim = math.sqrt(6.0 / (2 * d))
        params["layers"].append({
            "wq": rng.uniform(-lim, lim, (d, d)).astype(np.float32), "bq": np.zeros(d, np.float32),
            "wk": rng.uniform(-lim, lim, (d, d)).astype(np.float32), "bk": np.zeros(d, np.float32),
            "wv": rng.uniform(-lim, lim, (d, d)).astype(np.float32), "bv": np.zeros(d, np.float32),
            "wo": lin(d, d)["w"], "bo": np.zeros(d, np.float32),
            "lin1": lin(d, cfg.dim_ff), "lin2": lin(cfg.dim_ff, d),
            "ln1": {"scale": np.ones(d, np.float32), "bias": np.zeros(d, np.float32)},
            "ln2": {"scale": np.ones(d, np.float32), "bias": np.zeros(d, np.float32)},
        })
    return params


def randomize_affine(params: dict, seed: int) -> dict:
    """A copy of transencoder2s params whose attention and out-projection
    biases, LayerNorm scales and biases, ``trans_input`` BatchNorm
    parameters and running stats, and classifier biases are seeded random
    values, different in every layer. init_transenc leaves them all 0 or 1,
    as the reference's initialisation does; a trained checkpoint does not,
    so checks of the model run on these to make every operand count."""
    rng = np.random.RandomState(seed)
    out = copy.deepcopy(params)

    def bias(n):
        return (rng.randn(n) * 0.2).astype(np.float32)

    def scale(n):
        return rng.uniform(0.5, 1.5, n).astype(np.float32)

    for lp in out["layers"]:
        d = lp["bq"].shape[0]
        for k in ("bq", "bk", "bv", "bo"):
            lp[k] = bias(d)
        for k in ("ln1", "ln2"):
            lp[k] = {"scale": scale(d), "bias": bias(d)}
    for lin in out["classifier"]:
        lin["b"] = bias(lin["b"].shape[0])
    te = out["trans_input"]
    for bn in [te["bn1"], te["bn2"]] + [b["bn"] for b in te["plus"]]:
        c = bn["scale"].shape[0]
        bn.update(scale=scale(c), bias=bias(c), mean=(rng.randn(c) * 0.1).astype(np.float32),
                  var=rng.uniform(0.5, 2.0, c).astype(np.float32))
    return out


class _PosEncoder(nn.Module):
    def __init__(self, seq_len: int, d_model: int):
        super().__init__()
        self.pos_embed = nn.Embedding(seq_len, d_model)


class _SelfAttn(nn.Module):
    """nn.MultiheadAttention's parameter names: packed q|k|v rows."""

    def __init__(self, d_model: int):
        super().__init__()
        self.in_proj_weight = nn.Parameter(torch.empty(3 * d_model, d_model))
        self.in_proj_bias = nn.Parameter(torch.empty(3 * d_model))
        self.out_proj = nn.Linear(d_model, d_model)


class _EncoderLayer(nn.Module):
    """nn.TransformerEncoderLayer's parameter names."""

    def __init__(self, d_model: int, dim_ff: int):
        super().__init__()
        self.self_attn = _SelfAttn(d_model)
        self.linear1 = nn.Linear(d_model, dim_ff)
        self.linear2 = nn.Linear(dim_ff, d_model)
        self.norm1 = nn.LayerNorm(d_model)
        self.norm2 = nn.LayerNorm(d_model)


class _Encoder(nn.Module):
    def __init__(self, cfg: TransEncConfig):
        super().__init__()
        self.layers = nn.ModuleList([_EncoderLayer(cfg.d_model, cfg.dim_ff)
                                     for _ in range(cfg.num_layers)])

    def stacked(self, compute_dtype=torch.float32) -> dict:
        """The kernel layout (``ops.transenc.stack_layers``): Linear weights
        input-major, in_proj split into q | k | v columns."""
        D = self.layers[0].linear1.in_features
        layers = []
        for ly in self.layers:
            w, b = ly.self_attn.in_proj_weight, ly.self_attn.in_proj_bias
            layers.append({
                "wq": w[:D].T, "wk": w[D:2 * D].T, "wv": w[2 * D:].T,
                "bq": b[:D], "bk": b[D:2 * D], "bv": b[2 * D:],
                "wo": ly.self_attn.out_proj.weight.T, "bo": ly.self_attn.out_proj.bias,
                "lin1": {"w": ly.linear1.weight.T, "b": ly.linear1.bias},
                "lin2": {"w": ly.linear2.weight.T, "b": ly.linear2.bias},
                "ln1": {"scale": ly.norm1.weight, "bias": ly.norm1.bias},
                "ln2": {"scale": ly.norm2.weight, "bias": ly.norm2.bias}})
        return transenc.stack_layers(layers, compute_dtype)


class TransEnc(nn.Module):
    """transencoder2s forward: feats dict of tensors -> (logits, probs)."""

    def __init__(self, cfg: TransEncConfig):
        super().__init__()
        self.cfg = cfg
        d = cfg.d_model
        add_kinetics_embeds(self, cfg)
        self.trans_input = SrcEmbed(kinetics_width(cfg), d, 1)
        self.pos_encoder = _PosEncoder(cfg.seq_len, d)
        self.transformer_encoder = _Encoder(cfg)
        self.classifier = nn.Sequential(nn.Linear(2 * d, 2 * d), nn.ReLU(),
                                        nn.Dropout(cfg.dropout_rate),
                                        nn.Linear(2 * d, cfg.num_classes))
        self._stack_key, self._stack = None, None

    def stacked(self, compute_dtype=torch.float32) -> dict:
        """The encoder's weights in the kernel layout, built once and reused
        while no gradient is recorded and every encoder parameter is the
        same storage at the same version: call_mods' batches share one copy,
        and ``.to()`` or ``load_state_dict`` makes a new one."""
        if torch.is_grad_enabled():
            return self.transformer_encoder.stacked(compute_dtype)
        key = (compute_dtype,) + tuple((p.data_ptr(), p._version)
                                       for p in self.transformer_encoder.parameters())
        if key != self._stack_key:
            self._stack = self.transformer_encoder.stacked(compute_dtype)
            self._stack_key = key
        return self._stack

    def strand_input(self, feats: dict, suffix: str) -> torch.Tensor:
        """One strand's embedded and positioned encoder input (B, L, d_model)
        f32 (``transenc.py:141-175``, inference)."""
        x = self.trans_input(kinetics_embedded(self, self.cfg, feats, suffix))
        return x + self.pos_encoder.pos_embed.weight[None]

    def forward(self, feats: dict, compute_dtype=torch.float32, encoder_fn=None):
        """feats: kmer, kpass, ipd_means, pw_means (and stds/sns/maps when the
        config enables them), each also with suffix '2' for the reverse
        strand, as (B, L) tensors (sns (B, 4)). The encoder runs through
        ``encoder_fn`` (default ``ops.transenc.encoder_pooled``: K3 on CUDA,
        the plain version on the CPU) with operands in compute_dtype; the
        embeddings and the head run in f32."""
        cfg = self.cfg
        B = feats["kmer"].shape[0]
        x = torch.cat([self.strand_input(feats, ""),
                       self.strand_input(feats, "2")], dim=0)  # (2B, L, d)
        x = x.to(compute_dtype).contiguous()
        encoder_fn = transenc.encoder_pooled if encoder_fn is None else encoder_fn
        pooled = encoder_fn(self.stacked(compute_dtype), x, compute_dtype, cfg.nhead)
        out = torch.cat([pooled[:B], pooled[B:]], dim=1)  # (B, 2d)
        logits = self.classifier[3](torch.relu(self.classifier[0](out)))
        return logits, torch.softmax(logits, dim=1)

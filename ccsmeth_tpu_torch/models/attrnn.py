"""The two-strand attrnn families as a torch nn.Module: attbigru2s (the
default call_mods model) and attbilstm2s (scalar kinetics), attbigru2s2 and
attbilstm2s2 (embedded kinetics).

Counterpart of ``ccsmeth_tpu/models/attrnn.py`` (``apply_attrnn :224``), GRU
or LSTM cell:
  - per strand, the RNN input (``_strand_input :174-214``): the kmer
    embedding concatenated with the scalar kinetics channels (``*2s``), or
    with the seq, ipd, pw, npass and map embedding lookups and the
    ``SrcEmbed`` conv stacks of the stds and the sn (``*2s2``, C = 28 at the
    defaults);
  - both strands stacked on the batch axis and run through ONE shared BiRNN
    (``attrnn.py:243-244``): kernel K1 (``ops/bigru.py``, both cells) for
    inference, or K2 (the same module, one launch per layer) under
    rnn_backend 'pallas_layer'; kernels K4/K5 (``ops/bigru_vjp.py``, GRU) or K6
    (``ops/bilstm_vjp.py``, LSTM) for training; with explicit initial
    states (call_mods --h0_mode randn) the plain ``models/rnn.py::birnn_tm``,
    the counterpart of the XLA scan that the JAX package runs there
    (``attrnn.py:279-297``): K1 and the TPU kernel are zero-h0;
  - the attention query is the last layer's [fwd; bwd] h_n
    (``attrnn.py:217-221``);
  - attention per strand, then ``fc1`` (``*2s``) or the two-layer
    ``classifier`` (``*2s2``), and softmax (``attrnn.py:302-323``).

h0 (and the LSTM's c0) is zero, the engine's deterministic default. Attribute
names reproduce the reference state_dict keys (``embed``, ``seq_embed``,
``ipd_embed``, ``pw_embed``, ``npass_embed``, ``map_embed``,
``ipd_std_embed.*``, ``pw_std_embed.*``, ``sn_embed.*``,
``rnn.weight_ih_l{k}[_reverse]`` ..., ``_att3.{Wa,Ua,va}``, ``fc1``,
``classifier.{0,3}``), so a reference checkpoint loads with
``load_state_dict`` once its ``module.`` prefix is stripped.

Also here, as in the JAX package: ``SrcEmbed``, the conv stack that the 2s2
families and transencoder2s (``models/transenc.py``) embed inputs with
(``attrnn.py:65-115``), and ``AggrAttRNN``, call_freqb's aggregate model
(``attrnn.py:356-390``): a small BiRNN over the per-site histograms of a
window of sites, attention and a linear regression head.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..ops import bigru, bigru_vjp
from ..utils.constants import (MAX_KINETICS, MAX_MAP, MAX_PASSES, NEMBED_BASE,
                               NEMBED_KINETICS, NEMBED_KINETICS_STD, NEMBED_MAP,
                               NEMBED_PASSES, NEMBED_SN, N_VOCAB)
from .attention import Attention, init_attention
from .config import AggrConfig, AttRNNConfig
from .rnn import BiRNN, birnn_tm, init_rnn_params

# AttRNN forwards that ran the BiRNN with explicit initial states through the
# plain birnn_tm (call_mods --h0_mode randn), since the caller last set it to 0
h0_plain_calls = 0


PORTED = ("attbigru2s", "attbilstm2s", "attbigru2s2", "attbilstm2s2")


def init_src_embed(rng, input_dim: int, d_model: int, block_plus: int = 1) -> dict:
    """SrcEmbed params with the same draws as ``ccsmeth_tpu``'s
    init_src_embed (``attrnn.py:65-82``): conv weights (Cout, Cin, 3), BN
    scale 1, bias 0, running mean 0 and variance 1."""
    def conv(cin, cout, k=3):
        kk = 1.0 / math.sqrt(cin * k)
        return rng.uniform(-kk, kk, (cout, cin, k)).astype(np.float32)

    def bn(c):
        return {"scale": np.ones(c, np.float32), "bias": np.zeros(c, np.float32),
                "mean": np.zeros(c, np.float32), "var": np.ones(c, np.float32)}

    return {"conv1": conv(input_dim, d_model // 2), "bn1": bn(d_model // 2),
            "conv2": conv(d_model // 2, d_model), "bn2": bn(d_model),
            "plus": [{"conv": conv(d_model, d_model), "bn": bn(d_model)}
                     for _ in range(block_plus)]}


def conv1d_same(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x (N, L, Cin), w (Cout, Cin, K) torch layout, stride 1, padding K//2,
    no bias -> (N, L, Cout). Computed as the K shifted windows times the
    unfolded weight with ``torch.matmul``, not ``F.conv1d``: on CUDA a float32
    convolution goes through cuDNN in TF32 while
    ``torch.backends.cudnn.allow_tf32`` is True (its default), but a float32
    matmul stays float32 unless the caller turns
    ``torch.backends.cuda.matmul.allow_tf32`` on (default off)."""
    N, L, Cin = x.shape
    Cout, _, K = w.shape
    p = K // 2
    xp = F.pad(x, (0, 0, p, p))
    cols = torch.cat([xp[:, k:k + L] for k in range(K)], dim=2)  # (N, L, K*Cin)
    return cols @ w.permute(2, 1, 0).reshape(K * Cin, Cout)


def _maxpool3_same(x: torch.Tensor) -> torch.Tensor:
    """Max over a window of 3 along L, stride 1, -inf padding (N, L, C)."""
    xp = F.pad(x, (0, 0, 1, 1), value=float("-inf"))
    return torch.maximum(torch.maximum(xp[:, :-2], xp[:, 1:-1]), xp[:, 2:])


def _conv_block(cin: int, cout: int) -> list:
    return [nn.Conv1d(cin, cout, 3, padding=1, bias=False), nn.BatchNorm1d(cout),
            nn.ReLU(), nn.MaxPool1d(3, 1, 1)]


class _PlusBlock(nn.Module):
    def __init__(self, d_model: int):
        super().__init__()
        self.conv_embed = nn.Sequential(*_conv_block(d_model, d_model))


class SrcEmbed(nn.Module):
    """conv -> BN -> ReLU -> max-pool, twice, then ``block_plus`` more blocks
    (``attrnn.py:85-115``): (N, L, Cin) -> (N, L, d_model). The modules
    carry the reference state_dict names (``conv_embed.{0,1,4,5}``,
    ``conv_embed_plus.{i}.conv_embed.{0,1}``); the forward reads their
    weights and computes each block itself (``conv1d_same``), whatever the
    module's train()/eval() mode says. ``train=False`` normalises with the
    running stats (the JAX package's ``apply_src_embed`` in inference);
    ``train=True`` with the statistics of this call's input over (N, L),
    the biased variance, as JAX ``_bn(train=True)`` (``attrnn.py:94-100``),
    and writes nothing back to the running stats."""

    def __init__(self, input_dim: int, d_model: int, block_plus: int = 1):
        super().__init__()
        self.conv_embed = nn.Sequential(*_conv_block(input_dim, d_model // 2),
                                        *_conv_block(d_model // 2, d_model))
        self.conv_embed_plus = nn.ModuleList(
            [_PlusBlock(d_model) for _ in range(block_plus)])

    def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        blocks = [(self.conv_embed[0], self.conv_embed[1]),
                  (self.conv_embed[4], self.conv_embed[5])]
        blocks += [(b.conv_embed[0], b.conv_embed[1]) for b in self.conv_embed_plus]
        for conv, bn in blocks:
            h = conv1d_same(x, conv.weight)
            if train:
                mean = h.mean(dim=(0, 1))
                var = h.var(dim=(0, 1), unbiased=False)
            else:
                mean, var = bn.running_mean, bn.running_var
            h = (h - mean) * torch.rsqrt(var + bn.eps) * bn.weight + bn.bias
            x = _maxpool3_same(torch.relu(h))
        return x


def take_rows(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``jnp.take(table, idx.astype(int32), axis=0)`` on float indices:
    truncate toward zero, add the table length to indices in [-n, 0), and
    give a NaN row for an index outside [-n, n). (``nn.Embedding`` would
    raise on the CPU and assert on the card instead.) The lookup is
    ``F.embedding`` on the clamped indices, whose backward sums each table
    row's gradient in a fixed order on the card; the NaN rows get none."""
    n = table.shape[0]
    i = idx.to(torch.int64)
    i = torch.where(i < 0, i + n, i)
    inside = (i >= 0) & (i < n)
    rows = F.embedding(i.clamp(0, n - 1), table)
    return torch.where(inside[..., None], rows, torch.full_like(rows, float("nan")))


def _lin_init(rng, fan_in, fan_out, initrange=None):
    if initrange is not None:
        w = rng.uniform(-initrange, initrange, (fan_in, fan_out))
        b = np.zeros(fan_out)
    else:
        k = 1.0 / math.sqrt(fan_in)
        w = rng.uniform(-k, k, (fan_in, fan_out))
        b = rng.uniform(-k, k, (fan_out,))
    return {"w": w.astype(np.float32), "b": b.astype(np.float32)}


def kinetics_width(cfg) -> int:
    """The width of the embedded-kinetics input (``kinetics_embedded``):
    28 at the defaults, 52 with stds, sn and map."""
    return (NEMBED_BASE + 2 * NEMBED_KINETICS
            + (NEMBED_PASSES if cfg.is_npass else 0)
            + (2 * NEMBED_KINETICS_STD if cfg.is_stds else 0)
            + (NEMBED_SN if cfg.is_sn else 0) + (NEMBED_MAP if cfg.is_map else 0))


def add_kinetics_embeds(mod: nn.Module, cfg) -> None:
    """Give ``mod`` the embedded-kinetics input modules under the reference
    names (``seq_embed``, ``ipd_embed``, ``pw_embed``, and as ``cfg``
    enables them ``npass_embed``, ``ipd_std_embed``, ``pw_std_embed``,
    ``sn_embed``, ``map_embed``): the attbi*2s2 families' and
    transencoder2s's."""
    mod.seq_embed = nn.Embedding(N_VOCAB, NEMBED_BASE)
    mod.ipd_embed = nn.Embedding(MAX_KINETICS + 1, NEMBED_KINETICS)
    mod.pw_embed = nn.Embedding(MAX_KINETICS + 1, NEMBED_KINETICS)
    if cfg.is_npass:
        mod.npass_embed = nn.Embedding(MAX_PASSES + 1, NEMBED_PASSES)
    if cfg.is_stds:
        mod.ipd_std_embed = SrcEmbed(1, NEMBED_KINETICS_STD, 1)
        mod.pw_std_embed = SrcEmbed(1, NEMBED_KINETICS_STD, 1)
    if cfg.is_sn:
        mod.sn_embed = SrcEmbed(4, NEMBED_SN, 0)
    if cfg.is_map:
        mod.map_embed = nn.Embedding(MAX_MAP, NEMBED_MAP)


def kinetics_embedded(mod: nn.Module, cfg, feats: dict, suffix: str,
                      train: bool = False) -> torch.Tensor:
    """One strand's embedded input (B, L, C) through ``mod``'s modules of
    ``add_kinetics_embeds``, in the JAX package's order: seq, ipd, pw, npass,
    ipd_std, pw_std, sn, map (``attrnn.py:178-197``, ``transenc.py:
    141-170``). The lookups are ``take_rows`` (the JAX package's truncating
    ``jnp.take``; kpass clipped to [1, MAX_PASSES] first); the stds and the
    sn go through ``SrcEmbed``, on the batch's statistics when ``train``."""
    L = cfg.seq_len
    parts = [take_rows(mod.seq_embed.weight, feats["kmer" + suffix]),
             take_rows(mod.ipd_embed.weight, feats["ipd_means" + suffix]),
             take_rows(mod.pw_embed.weight, feats["pw_means" + suffix])]
    if cfg.is_npass:
        kp = torch.clamp(feats["kpass" + suffix].float(), 1, MAX_PASSES)
        parts.append(take_rows(mod.npass_embed.weight, kp))
    if cfg.is_stds:
        for key, emb in (("ipd_stds", mod.ipd_std_embed), ("pw_stds", mod.pw_std_embed)):
            parts.append(emb(feats[key + suffix].reshape(-1, L, 1).float(), train))
    if cfg.is_sn:
        sns = feats["sns" + suffix].float()
        parts.append(mod.sn_embed(sns[:, None, :].expand(sns.shape[0], L, 4), train))
    if cfg.is_map:
        parts.append(take_rows(mod.map_embed.weight, feats["maps" + suffix]))
    return torch.cat(parts, dim=2)


def init_attrnn(seed, cfg: AttRNNConfig) -> dict:
    """numpy params pytree with the same draws, in the same order, as
    ``ccsmeth_tpu``'s init_attrnn (``attrnn.py:131-171``) for the same seed,
    for the two-strand families. ``seed`` may be an int or an rng-like
    object (a shape-only probe for checkpoint shape checks)."""
    if cfg.model_type not in PORTED:
        raise NotImplementedError(
            "{} is not yet ported ({} only)".format(cfg.model_type, ", ".join(PORTED)))
    rng = seed if hasattr(seed, "uniform") else np.random.RandomState(seed)
    H = cfg.hidden_size
    params: dict = {}

    def table(rows, width):
        return rng.uniform(-0.1, 0.1, (rows, width)).astype(np.float32)

    if cfg.embedded_kinetics:
        params["seq_embed"] = table(N_VOCAB, NEMBED_BASE)
        params["ipd_embed"] = table(MAX_KINETICS + 1, NEMBED_KINETICS)
        params["pw_embed"] = table(MAX_KINETICS + 1, NEMBED_KINETICS)
        if cfg.is_stds:
            params["ipd_std_embed"] = init_src_embed(rng, 1, NEMBED_KINETICS_STD, 1)
            params["pw_std_embed"] = init_src_embed(rng, 1, NEMBED_KINETICS_STD, 1)
        if cfg.is_npass:
            params["npass_embed"] = table(MAX_PASSES + 1, NEMBED_PASSES)
        if cfg.is_sn:
            params["sn_embed"] = init_src_embed(rng, 4, NEMBED_SN, 0)
        if cfg.is_map:
            params["map_embed"] = table(MAX_MAP, NEMBED_MAP)
    else:
        params["embed"] = table(N_VOCAB, NEMBED_BASE)
    params["rnn"] = init_rnn_params(rng, rnn_input_size(cfg), H, cfg.num_layers,
                                    cfg.rnn_cell)
    params["att"] = init_attention(rng, H * 2, H * 2, H)
    fc_in = H * 2 * (2 if cfg.two_strand else 1)
    if cfg.embedded_kinetics:
        params["classifier"] = [_lin_init(rng, fc_in, fc_in, initrange=0.1),
                                _lin_init(rng, fc_in, cfg.num_classes, initrange=0.1)]
    else:
        params["fc1"] = _lin_init(rng, fc_in, cfg.num_classes, initrange=0.1)
    return params


def rnn_input_size(cfg: AttRNNConfig) -> int:
    """C, the width of the BiRNN's input: the kmer embedding and the scalar
    channels (``*2s``: 11 at the defaults), or the embeddings (``*2s2``: 28
    at the defaults, 52 with stds, sn and map)."""
    return kinetics_width(cfg) if cfg.embedded_kinetics else NEMBED_BASE + cfg.feas_ccs


class AttRNN(nn.Module):
    """The two-strand families' forward: feats dict of tensors -> (logits,
    probs)."""

    def __init__(self, cfg: AttRNNConfig, rnn_backend: str = "xla"):
        super().__init__()
        if cfg.model_type not in PORTED:
            raise NotImplementedError(
                "model_type {} is not yet ported ({} only)".format(
                    cfg.model_type, ", ".join(PORTED)))
        if rnn_backend not in ("xla", "pallas", "pallas_layer"):
            raise ValueError("rnn_backend must be xla, pallas or pallas_layer")
        self.cfg = cfg
        self.rnn_backend = rnn_backend
        H = cfg.hidden_size
        if cfg.embedded_kinetics:
            add_kinetics_embeds(self, cfg)
        else:
            self.embed = nn.Embedding(N_VOCAB, NEMBED_BASE)
        self.rnn = BiRNN(rnn_input_size(cfg), H, cfg.num_layers, cfg.rnn_cell)
        self._att3 = Attention(2 * H, 2 * H, H)
        if cfg.embedded_kinetics:
            # the reference's Linear, ReLU, Dropout, Linear: state_dict keys
            # classifier.0 and classifier.3
            self.classifier = nn.Sequential(
                nn.Linear(4 * H, 4 * H), nn.ReLU(), nn.Dropout(cfg.dropout_rate),
                nn.Linear(4 * H, cfg.num_classes))
        else:
            self.fc1 = nn.Linear(4 * H, cfg.num_classes)

    def strand_input(self, feats: dict, suffix: str, train: bool = False) -> torch.Tensor:
        """One strand's (B, L, C) RNN input (``attrnn.py:174-214``): the
        kmer embedding and the scalar channels, or ``kinetics_embedded``."""
        cfg = self.cfg
        if cfg.embedded_kinetics:
            return kinetics_embedded(self, cfg, feats, suffix, train)
        L = cfg.seq_len

        def chan(key):
            return feats[key + suffix].reshape(-1, L, 1).float()

        parts = [self.embed(feats["kmer" + suffix].long()),
                 chan("ipd_means"), chan("pw_means")]
        if cfg.is_npass:
            parts.append(chan("kpass"))
        if cfg.is_stds:
            parts += [chan("ipd_stds"), chan("pw_stds")]
        if cfg.is_sn:
            sns = feats["sns" + suffix].float()
            parts.append(sns[:, None, :].expand(sns.shape[0], L, 4))
        if cfg.is_map:
            parts.append(chan("maps"))
        return torch.cat(parts, dim=2)

    def forward(self, feats: dict, compute_dtype=torch.float32, train=False,
                generator=None, rnn_fn=None, h0s=None):
        """feats: kmer, kpass, ipd_means, pw_means (and stds/sns/maps when the
        config enables them), each also with suffix '2' for the reverse
        strand, as (B, L) tensors (sns (B, 4)). The BiRNN runs with operands
        in compute_dtype; attention and head run in f32.

        train=False (inference) runs the BiRNN through ``rnn_fn``:
        ``ops.bigru.birnn_stack`` (K1) by default, ``ops.bigru.birnn_layers``
        (K2, one launch per layer) when the module was built with
        rnn_backend='pallas_layer' (``attrnn.py:249-256``), or a plain
        version of either. ``h0s`` ({'h0', 'h0_2'[, 'c0', 'c0_2']}, each
        (2*NL, B, H), the JAX package's apply_attrnn keywords) runs it through
        the plain ``birnn_tm`` in f32 instead, as the JAX package's XLA scan
        does (``attrnn.py:279-297``), counted in ``h0_plain_calls``.
        train=True runs it layer by layer through
        ``ops.bigru_vjp.birnn_apply_trainable`` (K4/K5 for the GRU, K6 for
        the LSTM), with dropout at cfg.dropout_rate between layers and on the
        context before fc1, or on the classifier's hidden layer for the
        embedded families (``attrnn.py:257-267,313-321``), masks drawn from
        ``generator`` (no generator: no dropout); the embedded families'
        ``SrcEmbed`` BatchNorms then use the batch's statistics."""
        global h0_plain_calls
        cfg = self.cfg
        H = cfg.hidden_size
        B = feats["kmer"].shape[0]
        both = torch.cat([self.strand_input(feats, "", train),
                          self.strand_input(feats, "2", train)], dim=0)  # (2B, L, C)
        if train:
            outs, h_n = bigru_vjp.birnn_apply_trainable(
                self.rnn.stacked(), both, compute_dtype, cfg.dropout_rate,
                generator, cfg.rnn_cell)
        elif h0s is not None:
            def states(key):
                if key not in h0s:
                    return None
                return torch.cat([h0s[key], h0s[key + "_2"]], dim=1).float()

            h0_plain_calls += 1
            out_tm, h_n = birnn_tm(self.rnn.stacked(), both.transpose(0, 1),
                                   states("h0"), torch.float32, cfg.rnn_cell,
                                   states("c0"))
            outs = out_tm.transpose(0, 1)
        else:
            if rnn_fn is None:
                rnn_fn = (bigru.birnn_layers if self.rnn_backend == "pallas_layer"
                          else bigru.birnn_stack)
            x_tm = both.transpose(0, 1).to(compute_dtype).contiguous()
            out_tm, h_n = rnn_fn(self.rnn.stacked(compute_dtype), x_tm,
                                 compute_dtype, cfg.rnn_cell)
            outs = out_tm.transpose(0, 1).float()  # (2B, L, 2H)
        last = h_n.reshape(cfg.num_layers, 2, 2 * B, H)[-1]  # (2, 2B, H)
        query = last.transpose(0, 1).reshape(2 * B, 1, 2 * H)
        ctx, _ = self._att3(query, outs)  # (2B, 2H)
        out = torch.cat([ctx[:B], ctx[B:]], dim=1)  # (B, 4H)
        if cfg.embedded_kinetics:
            out = torch.relu(self.classifier[0](out))
            if train:
                out = bigru_vjp.dropout(out, cfg.dropout_rate, generator)
            logits = self.classifier[3](out)
        else:
            if train:
                out = bigru_vjp.dropout(out, cfg.dropout_rate, generator)
            logits = self.fc1(out)
        return logits, torch.softmax(logits, dim=1)


def init_aggr_attrnn(seed, cfg: AggrConfig) -> dict:
    """numpy params pytree of the aggregate model with the same draws as
    ``ccsmeth_tpu``'s init_aggr_attrnn (``attrnn.py:356-365``), in its
    order: the BiRNN over binsize + 1 channels, the attention, fc1.
    ``seed`` may be an int or an rng-like object."""
    rng = seed if hasattr(seed, "uniform") else np.random.RandomState(seed)
    H = cfg.hidden_size
    return {
        "rnn": init_rnn_params(rng, cfg.binsize + 1, H, cfg.num_layers, cfg.rnn_cell),
        "att": init_attention(rng, H * 2, H * 2, H),
        "fc1": _lin_init(rng, H * 2, cfg.num_classes),
    }


class AggrAttRNN(nn.Module):
    """call_freqb's aggregate model (``apply_aggr_attrnn``,
    ``attrnn.py:368-390``): offsets (B, L) and histograms (B, L, binsize)
    -> the raw regression output (B, num_classes), no softmax. The offsets
    are the last input channel; h0 (and c0) are zero; the BiRNN runs
    through ``rnn_fn``, ``ops.bigru.birnn_stack`` by default (kernel K1 on
    a CUDA tensor, its plain version on a CPU tensor). State_dict names are
    the reference's (``rnn.*``, ``_att3.*``, ``fc1``)."""

    def __init__(self, cfg: AggrConfig):
        super().__init__()
        self.cfg = cfg
        H = cfg.hidden_size
        self.rnn = BiRNN(cfg.binsize + 1, H, cfg.num_layers, cfg.rnn_cell)
        self._att3 = Attention(2 * H, 2 * H, H)
        self.fc1 = nn.Linear(2 * H, cfg.num_classes)

    def forward(self, offsets: torch.Tensor, histos: torch.Tensor, rnn_fn=None):
        cfg = self.cfg
        H = cfg.hidden_size
        B = offsets.shape[0]
        x = torch.cat([histos.float(), offsets.reshape(B, cfg.seq_len, 1).float()],
                      dim=2)
        rnn_fn = bigru.birnn_stack if rnn_fn is None else rnn_fn
        out_tm, h_n = rnn_fn(self.rnn.stacked(), x.transpose(0, 1).contiguous(),
                             torch.float32, cfg.rnn_cell)
        last = h_n.reshape(cfg.num_layers, 2, B, H)[-1]  # (2, B, H)
        query = last.transpose(0, 1).reshape(B, 1, 2 * H)
        ctx, _ = self._att3(query, out_tm.transpose(0, 1))
        return self.fc1(ctx)

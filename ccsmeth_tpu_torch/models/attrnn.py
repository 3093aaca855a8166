"""attbigru2s (the default call_mods model) and attbilstm2s as a torch
nn.Module.

Counterpart of ``ccsmeth_tpu/models/attrnn.py`` (``apply_attrnn :224``) for the
scalar-kinetics, two-strand families, GRU or LSTM cell:
  - per strand, the kmer embedding concatenated with the scalar kinetics
    channels (``attrnn.py:199-214``);
  - both strands stacked on the batch axis and run through ONE shared BiRNN
    (``attrnn.py:243-244``): kernel K1 (``ops/bigru.py``, both cells) for
    inference, or K2 (the same module, one launch per layer) under
    rnn_backend 'pallas_layer'; kernels K4/K5 (``ops/bigru_vjp.py``, GRU) or K6
    (``ops/bilstm_vjp.py``, LSTM) for training;
  - the attention query is the last layer's [fwd; bwd] h_n
    (``attrnn.py:217-221``);
  - attention per strand, then ``fc1`` and softmax (``attrnn.py:302-323``).

h0 (and the LSTM's c0) is zero, the engine's deterministic default. Attribute names reproduce the
reference state_dict keys (``embed``, ``rnn.weight_ih_l{k}[_reverse]`` ...,
``_att3.{Wa,Ua,va}``, ``fc1``), so a reference checkpoint loads with
``load_state_dict`` once its ``module.`` prefix is stripped.

Also here, as in the JAX package: ``SrcEmbed``, the conv stack that
transencoder2s (``models/transenc.py``) embeds its input with
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
from ..utils.constants import NEMBED_BASE, N_VOCAB
from .attention import Attention, init_attention
from .config import AggrConfig, AttRNNConfig
from .rnn import BiRNN, init_rnn_params


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
    """conv -> BN on its running stats -> ReLU -> max-pool, twice, then
    ``block_plus`` more blocks (``attrnn.py:85-115``): (N, L, Cin) ->
    (N, L, d_model). The modules carry the reference state_dict names
    (``conv_embed.{0,1,4,5}``, ``conv_embed_plus.{i}.conv_embed.{0,1}``); the
    forward reads their weights and running stats and computes each block
    itself (``conv1d_same``), the same in train() and eval() mode: the
    inference semantics of the JAX package's ``apply_src_embed``."""

    def __init__(self, input_dim: int, d_model: int, block_plus: int = 1):
        super().__init__()
        self.conv_embed = nn.Sequential(*_conv_block(input_dim, d_model // 2),
                                        *_conv_block(d_model // 2, d_model))
        self.conv_embed_plus = nn.ModuleList(
            [_PlusBlock(d_model) for _ in range(block_plus)])

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        blocks = [(self.conv_embed[0], self.conv_embed[1]),
                  (self.conv_embed[4], self.conv_embed[5])]
        blocks += [(b.conv_embed[0], b.conv_embed[1]) for b in self.conv_embed_plus]
        for conv, bn in blocks:
            h = conv1d_same(x, conv.weight)
            h = ((h - bn.running_mean) * torch.rsqrt(bn.running_var + bn.eps)
                 * bn.weight + bn.bias)
            x = _maxpool3_same(torch.relu(h))
        return x


def _lin_init(rng, fan_in, fan_out, initrange=None):
    if initrange is not None:
        w = rng.uniform(-initrange, initrange, (fan_in, fan_out))
        b = np.zeros(fan_out)
    else:
        k = 1.0 / math.sqrt(fan_in)
        w = rng.uniform(-k, k, (fan_in, fan_out))
        b = rng.uniform(-k, k, (fan_out,))
    return {"w": w.astype(np.float32), "b": b.astype(np.float32)}


def init_attrnn(seed, cfg: AttRNNConfig) -> dict:
    """numpy params pytree with the same draws as ``ccsmeth_tpu``'s
    init_attrnn (``attrnn.py:131-171``) for the same seed, for the
    scalar-kinetics families. ``seed`` may be an int or an rng-like object
    (a shape-only probe for checkpoint shape checks)."""
    if cfg.embedded_kinetics:
        raise NotImplementedError(
            "{} (embedded kinetics) is not yet ported".format(cfg.model_type))
    rng = seed if hasattr(seed, "uniform") else np.random.RandomState(seed)
    H = cfg.hidden_size
    params: dict = {}
    params["embed"] = rng.uniform(-0.1, 0.1, (N_VOCAB, NEMBED_BASE)).astype(np.float32)
    rnn_in = NEMBED_BASE + cfg.feas_ccs
    params["rnn"] = init_rnn_params(rng, rnn_in, H, cfg.num_layers, cfg.rnn_cell)
    params["att"] = init_attention(rng, H * 2, H * 2, H)
    fc_in = H * 2 * (2 if cfg.two_strand else 1)
    params["fc1"] = _lin_init(rng, fc_in, cfg.num_classes, initrange=0.1)
    return params


PORTED = ("attbigru2s", "attbilstm2s")


class AttRNN(nn.Module):
    """attbigru2s / attbilstm2s forward: feats dict of tensors -> (logits,
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
        self.embed = nn.Embedding(N_VOCAB, NEMBED_BASE)
        self.rnn = BiRNN(NEMBED_BASE + cfg.feas_ccs, H, cfg.num_layers,
                         cfg.rnn_cell)
        self._att3 = Attention(2 * H, 2 * H, H)
        self.fc1 = nn.Linear(4 * H, cfg.num_classes)

    def strand_input(self, feats: dict, suffix: str) -> torch.Tensor:
        """One strand's (B, L, C) RNN input (``attrnn.py:199-214``)."""
        cfg = self.cfg
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
                generator=None, rnn_fn=None):
        """feats: kmer, kpass, ipd_means, pw_means (and stds/sns/maps when the
        config enables them), each also with suffix '2' for the reverse
        strand, as (B, L) tensors (sns (B, 4)). The BiRNN runs with operands
        in compute_dtype; attention and head run in f32.

        train=False (inference) runs the BiRNN through ``rnn_fn``:
        ``ops.bigru.birnn_stack`` (K1) by default, ``ops.bigru.birnn_layers``
        (K2, one launch per layer) when the module was built with
        rnn_backend='pallas_layer' (``attrnn.py:249-256``), or a plain
        version of either. train=True runs it layer by layer
        through ``ops.bigru_vjp.birnn_apply_trainable`` (K4/K5 for the GRU,
        K6 for the LSTM), with dropout
        at cfg.dropout_rate between layers and on the context before fc1
        (``attrnn.py:257-267,320-321``), masks drawn from ``generator``
        (no generator: no dropout)."""
        cfg = self.cfg
        H = cfg.hidden_size
        B = feats["kmer"].shape[0]
        both = torch.cat([self.strand_input(feats, ""),
                          self.strand_input(feats, "2")], dim=0)  # (2B, L, C)
        if train:
            outs, h_n = bigru_vjp.birnn_apply_trainable(
                self.rnn.stacked(), both, compute_dtype, cfg.dropout_rate,
                generator, cfg.rnn_cell)
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

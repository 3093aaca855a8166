"""attbigru2s (the default call_mods model) and attbilstm2s as a torch
nn.Module.

Counterpart of ``ccsmeth_tpu/models/attrnn.py`` (``apply_attrnn :224``) for the
scalar-kinetics, two-strand families, GRU or LSTM cell:
  - per strand, the kmer embedding concatenated with the scalar kinetics
    channels (``attrnn.py:199-214``);
  - both strands stacked on the batch axis and run through ONE shared BiRNN
    (``attrnn.py:243-244``): kernel K1 (``ops/bigru.py``, both cells) for
    inference; kernels K4/K5 (``ops/bigru_vjp.py``, GRU) or K6
    (``ops/bilstm_vjp.py``, LSTM) for training;
  - the attention query is the last layer's [fwd; bwd] h_n
    (``attrnn.py:217-221``);
  - attention per strand, then ``fc1`` and softmax (``attrnn.py:302-323``).

h0 (and the LSTM's c0) is zero, the engine's deterministic default. Attribute names reproduce the
reference state_dict keys (``embed``, ``rnn.weight_ih_l{k}[_reverse]`` ...,
``_att3.{Wa,Ua,va}``, ``fc1``), so a reference checkpoint loads with
``load_state_dict`` once its ``module.`` prefix is stripped.
"""

from __future__ import annotations

import math

import numpy as np
import torch
from torch import nn

from ..ops import bigru, bigru_vjp
from ..utils.constants import NEMBED_BASE, N_VOCAB
from .attention import Attention, init_attention
from .config import AttRNNConfig
from .rnn import BiRNN, init_rnn_params


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

    def __init__(self, cfg: AttRNNConfig):
        super().__init__()
        if cfg.model_type not in PORTED:
            raise NotImplementedError(
                "model_type {} is not yet ported ({} only)".format(
                    cfg.model_type, ", ".join(PORTED)))
        self.cfg = cfg
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
        ``ops.bigru.birnn_stack`` (K1) by default, or its plain version
        ``ops.bigru.birnn_stack_plain``. train=True runs it layer by layer
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
            rnn_fn = bigru.birnn_stack if rnn_fn is None else rnn_fn
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

"""Bahdanau additive attention.

Counterpart of ``ccsmeth_tpu/models/attention.py``:
  score   = va . tanh(Wa q + Ua K)        (N, L)
  weights = softmax over L                (N, L)
  context = K^T @ weights                 (N, K)

The module stores Wa, Ua and va as bias-free nn.Linear layers (torch's
(out, in) layout, the reference's state_dict keys ``_att3.{Wa,Ua,va}.weight``);
the numpy init keeps the JAX package's input-major layout.
"""

from __future__ import annotations

import math

import numpy as np
import torch
from torch import nn


def init_attention(rng: np.random.RandomState, query_size: int, key_size: int,
                   hidden_size: int) -> dict:
    """torch nn.Linear default init (kaiming_uniform a=sqrt(5) == U(-1/sqrt(fan_in), ...))."""

    def lin(fan_in, fan_out):
        k = 1.0 / math.sqrt(fan_in)
        return rng.uniform(-k, k, (fan_in, fan_out)).astype(np.float32)

    return {
        "Wa": lin(query_size, hidden_size),
        "Ua": lin(key_size, hidden_size),
        "va": lin(hidden_size, 1),
    }


def attention(query: torch.Tensor, keys: torch.Tensor, wa: torch.Tensor,
              ua: torch.Tensor, va: torch.Tensor):
    """query (N, 1, Q), keys (N, L, K); wa (hidden, Q), ua (hidden, K),
    va (1, hidden) in nn.Linear layout. Returns (context (N, K), weights (N, L))."""
    e = torch.tanh(query @ wa.T + keys @ ua.T)  # (N, L, hidden)
    scores = (e @ va.T)[..., 0]  # (N, L)
    weights = torch.softmax(scores, dim=1)
    context = torch.einsum("nlk,nl->nk", keys, weights)
    return context, weights


class Attention(nn.Module):
    def __init__(self, query_size: int, key_size: int, hidden_size: int):
        super().__init__()
        self.Wa = nn.Linear(query_size, hidden_size, bias=False)
        self.Ua = nn.Linear(key_size, hidden_size, bias=False)
        self.va = nn.Linear(hidden_size, 1, bias=False)

    def forward(self, query: torch.Tensor, keys: torch.Tensor):
        return attention(query, keys, self.Wa.weight, self.Ua.weight,
                         self.va.weight)

"""Bidirectional multi-layer GRU and LSTM in plain PyTorch.

Counterpart of ``ccsmeth_tpu/models/rnn.py`` (``birnn_apply :49``). Gate math
follows torch.nn.GRU and torch.nn.LSTM: GRU gate order r, z, n with ``b_hn``
inside the reset product (``ccsmeth_tpu/models/rnn.py:92-95``); LSTM gate
order i, f, g, o (``:104-115``). This is also the plain version beside kernel
K1 (``ops/bigru.py``): with bf16 operands it rounds the weights, the layer
inputs and the h operand of the recurrent product to bf16, multiplies exactly
and sums in float32, as the kernel does; the LSTM's c stays float32.

``BiRNN`` holds its parameters under nn.GRU's or nn.LSTM's names
(``weight_ih_l{k}``, ``weight_hh_l{k}``, ``bias_ih_l{k}``, ``bias_hh_l{k}``,
``_reverse`` for the backward direction), so a reference checkpoint loads
into it unchanged.
"""

from __future__ import annotations

import math

import numpy as np
import torch
from torch import nn


def init_rnn_params(rng: np.random.RandomState, input_size: int, hidden_size: int,
                    num_layers: int, cell: str = "gru") -> list[dict]:
    """torch-default init: uniform(-1/sqrt(H), 1/sqrt(H)) for every tensor
    (numpy; same draws as ``ccsmeth_tpu/models/rnn.py:29-46``)."""
    gates = 3 if cell == "gru" else 4
    k = 1.0 / math.sqrt(hidden_size)
    layers = []
    for layer in range(num_layers):
        in_sz = input_size if layer == 0 else hidden_size * 2
        ld = {}
        for d in ("fwd", "bwd"):
            ld[d] = {
                "w_ih": rng.uniform(-k, k, (gates * hidden_size, in_sz)).astype(np.float32),
                "w_hh": rng.uniform(-k, k, (gates * hidden_size, hidden_size)).astype(np.float32),
                "b_ih": rng.uniform(-k, k, (gates * hidden_size,)).astype(np.float32),
                "b_hh": rng.uniform(-k, k, (gates * hidden_size,)).astype(np.float32),
            }
        layers.append(ld)
    return layers


def gru_cell(xg: torch.Tensor, hg: torch.Tensor, h: torch.Tensor):
    """One GRU step from its gate sums: xg = x_t W_ih + b_ih and
    hg = h W_hh + b_hh, both (N, 3H) in f32, gate order r, z, n. Returns
    (h', r, z, n); hg[:, 2H:] is hg_n, the recurrent part of n."""
    H = h.shape[-1]
    r = torch.sigmoid(xg[:, :H] + hg[:, :H])
    z = torch.sigmoid(xg[:, H:2 * H] + hg[:, H:2 * H])
    n = torch.tanh(xg[:, 2 * H:] + r * hg[:, 2 * H:])
    return (1.0 - z) * n + z * h, r, z, n


def lstm_cell(g: torch.Tensor, c: torch.Tensor):
    """One LSTM step from its summed gates g = x_t W_ih + b_ih + h W_hh + b_hh,
    (N, 4H) in f32, gate order i, f, g, o, and the cell state c (N, H) f32.
    Returns (h', c', i, f, g, o)."""
    H = c.shape[-1]
    i = torch.sigmoid(g[:, :H])
    f = torch.sigmoid(g[:, H:2 * H])
    gg = torch.tanh(g[:, 2 * H:3 * H])
    o = torch.sigmoid(g[:, 3 * H:])
    c_new = f * c + i * gg
    return o * torch.tanh(c_new), c_new, i, f, gg, o


def n_gates(cell: str) -> int:
    if cell not in ("gru", "lstm"):
        raise ValueError("cell must be gru or lstm, got {!r}".format(cell))
    return 3 if cell == "gru" else 4


def birnn_tm(layers, x: torch.Tensor, h0: torch.Tensor | None = None,
             compute_dtype=torch.float32, cell: str = "gru",
             c0: torch.Tensor | None = None):
    """Time-major stacked BiGRU or BiLSTM.

    layers: [(w_ih (2, C, G), b_ih (2, G), w_hh (2, H, G), b_hh (2, G))] per
    layer, G = 3H (GRU) or 4H (LSTM), direction 0 forward and 1 backward (the
    ``_layer_weights`` layout). x: (L, N, C). h0 (and c0 for the LSTM):
    optional (2*NL, N, H) in torch order; zero by default. Returns
    (out (L, N, 2H) in compute_dtype, h_n (2*NL, N, H) f32); c_n is not
    returned, as in the JAX package. Between layers the activations are
    rounded to compute_dtype.
    """
    L, N, _ = x.shape
    H = layers[0][2].shape[1]
    G = n_gates(cell) * H

    def op(t):
        return t.to(compute_dtype).float()

    def state0(s0, k):
        return (torch.zeros((N, H), dtype=torch.float32, device=x.device)
                if s0 is None else s0[k].float())

    inp = x
    h_ns = []
    for li, (wih, bih, whh, bhh) in enumerate(layers):
        flat = op(inp).reshape(L * N, -1)
        outs = []
        for d in (0, 1):
            xg = (flat @ op(wih[d]) + bih[d].float()).reshape(L, N, G)
            w = op(whh[d])
            b = bhh[d].float()
            h = state0(h0, 2 * li + d)
            c = state0(c0, 2 * li + d)
            ys = [None] * L
            for s in range(L):
                t = s if d == 0 else L - 1 - s
                hg = op(h) @ w + b
                if cell == "gru":
                    h = gru_cell(xg[t], hg, h)[0]
                else:
                    h, c = lstm_cell(xg[t] + hg, c)[:2]
                ys[t] = h
            h_ns.append(h)
            outs.append(torch.stack(ys))
        inp = torch.cat(outs, dim=-1).to(compute_dtype)
    return inp, torch.stack(h_ns)


def birnn_apply(layers, x: torch.Tensor, h0: torch.Tensor | None = None,
                compute_dtype=torch.float32, cell: str = "gru",
                c0: torch.Tensor | None = None):
    """Batch-major form, the same function as ``ccsmeth_tpu``'s birnn_apply:
    x (B, L, C) -> (outputs (B, L, 2H) f32, h_n (2*NL, B, H) f32)."""
    out, h_n = birnn_tm(layers, x.transpose(0, 1), h0, compute_dtype, cell, c0)
    return out.transpose(0, 1).float(), h_n


def layer_weights(layer: dict, compute_dtype=torch.float32, device=None):
    """One layer of a params pytree ({'fwd': {'w_ih', 'w_hh', 'b_ih', 'b_hh'},
    'bwd': ...}, torch (G*H, in) layout; numpy arrays or tensors) -> the
    stacked kernel layout (w_ih (2, C, G), b_ih, w_hh (2, H, G), b_hh),
    G = 3H or 4H, weights in compute_dtype and biases in f32."""
    def both(key, transpose):
        ts = [torch.as_tensor(layer[d][key], device=device) for d in ("fwd", "bwd")]
        return torch.stack([t.T if transpose else t for t in ts])

    return (both("w_ih", True).to(compute_dtype).contiguous(),
            both("b_ih", False).float().contiguous(),
            both("w_hh", True).to(compute_dtype).contiguous(),
            both("b_hh", False).float().contiguous())


class BiRNN(nn.Module):
    """Parameter holder with nn.GRU's (cell 'gru') or nn.LSTM's (cell
    'lstm') names; ``stacked`` gives the kernel layout. It runs through
    ``ops.bigru.birnn_stack`` (or its plain version) and the training
    kernels' autograd functions, never through cuDNN."""

    def __init__(self, input_size: int, hidden_size: int, num_layers: int,
                 cell: str = "gru"):
        super().__init__()
        self.input_size = input_size
        self.hidden_size = hidden_size
        self.num_layers = num_layers
        self.cell = cell
        G = n_gates(cell) * hidden_size
        for k in range(num_layers):
            in_sz = input_size if k == 0 else 2 * hidden_size
            for suf in ("", "_reverse"):
                self.register_parameter("weight_ih_l{}{}".format(k, suf),
                                        nn.Parameter(torch.empty(G, in_sz)))
                self.register_parameter("weight_hh_l{}{}".format(k, suf),
                                        nn.Parameter(torch.empty(G, hidden_size)))
                self.register_parameter("bias_ih_l{}{}".format(k, suf),
                                        nn.Parameter(torch.empty(G)))
                self.register_parameter("bias_hh_l{}{}".format(k, suf),
                                        nn.Parameter(torch.empty(G)))
        self.reset_parameters()

    def reset_parameters(self, generator: torch.Generator | None = None):
        k = 1.0 / math.sqrt(self.hidden_size)
        with torch.no_grad():
            for p in self.parameters():
                p.uniform_(-k, k, generator=generator)

    def stacked(self, compute_dtype=torch.float32):
        """[(w_ih (2, C, G), b_ih (2, G) f32, w_hh (2, H, G), b_hh f32)] per
        layer, G = 3H (GRU) or 4H (LSTM), weights in compute_dtype."""
        names = (("w_ih", "weight_ih"), ("w_hh", "weight_hh"),
                 ("b_ih", "bias_ih"), ("b_hh", "bias_hh"))
        return [layer_weights(
            {d: {key: getattr(self, "{}_l{}{}".format(name, k, suf))
                 for key, name in names}
             for d, suf in (("fwd", ""), ("bwd", "_reverse"))}, compute_dtype)
            for k in range(self.num_layers)]

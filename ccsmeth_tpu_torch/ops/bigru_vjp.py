"""Kernels K4 and K5: one bidirectional GRU layer for training.

Counterpart of ``ccsmeth_tpu/ops/bigru_pallas_vjp.py``: K4 replaces
``_fwd_kernel`` (the forward that keeps the gate residuals) and K5 replaces
``_bwd_kernel`` (the backward); together they are ``fused_bigru_layer_tm``, a
``jax.custom_vjp``, here ``BiGRULayerFn``, a ``torch.autograd.Function``. The
source is ``csrc/bigru_train.cu``; its header says what bounds the kernels on
an H100 and what the design does about that.

Layouts (time-major; direction 0 forward, 1 backward, both in natural time
order, unlike the TPU kernel which stores the backward half reversed):

    x      (L, N, C)       operand type (float32 or bfloat16)
    w_ih   (2, C, 3H)      operand type     b_ih (2, 3H) f32
    w_hh   (2, H, 3H)      operand type     b_hh (2, 3H) f32
    out    (L, N, 2H)      store type (= operand type)
    gates  (2, L, N, 4H)   store type: r, z, n, hg_n per direction
    dout   (L, N, 2H)      store type
    ->     dx (L, N, C), dw_ih (2, C, 3H), db_ih (2, 3H), dw_hh (2, H, 3H),
           db_hh (2, 3H), all f32

A CUDA tensor launches the kernel (or raises); a CPU tensor runs the plain
version beside it. ``launches_fwd`` and ``launches_bwd`` count kernel launches,
``plain_calls`` runs of the plain versions. The kernels are compiled with
``nvcc`` at first use (``nvcc.py``); nothing here imports a GPU toolchain at
import time.
"""

from __future__ import annotations

import ctypes
import threading

import torch

from ..models.rnn import gru_cell
from . import bilstm_vjp, nvcc
from .kernel_args import (DTYPE_CODE, cuda_checks, device_of, dims, expect, op,
                         tile, wgrad_slices)

SRC = "bigru_train.cu"

launches_fwd = 0  # K4 launches since the caller last set it to 0
launches_bwd = 0  # K5 launches
plain_calls = 0  # runs of either plain version

_lib = None
_lock = threading.Lock()


def build() -> str:
    """Compile ``csrc/bigru_train.cu`` if its library is missing; returns the
    library path. Raises with nvcc's output when the build fails."""
    return nvcc.build(SRC)[0]


def _load():
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(build())
            p, i = ctypes.c_void_p, ctypes.c_int
            lib.bigru_train_fwd_launch.restype = i
            lib.bigru_train_fwd_launch.argtypes = [i] + [p] * 7 + [i] * 6 + [p]
            lib.bigru_train_bwd_launch.restype = i
            lib.bigru_train_bwd_launch.argtypes = [i] + [p] * 11 + [i] * 7 + [p]
            _lib = lib
    return _lib


def _check_fwd(x, w_ih, b_ih, w_hh, b_hh, compute_dtype):
    L, N, C, H = dims(x, w_hh, compute_dtype)
    dev = x.device
    expect("x", x, (L, N, C), compute_dtype, dev)
    expect("w_ih", w_ih, (2, C, 3 * H), compute_dtype, dev)
    expect("b_ih", b_ih, (2, 3 * H), torch.float32, dev)
    expect("w_hh", w_hh, (2, H, 3 * H), compute_dtype, dev)
    expect("b_hh", b_hh, (2, 3 * H), torch.float32, dev)
    return L, N, C, H


def _check_bwd(dout, x, w_ih, w_hh, out, gates, compute_dtype):
    L, N, C, H = dims(x, w_hh, compute_dtype)
    dev = x.device
    expect("x", x, (L, N, C), compute_dtype, dev)
    expect("w_ih", w_ih, (2, C, 3 * H), compute_dtype, dev)
    expect("w_hh", w_hh, (2, H, 3 * H), compute_dtype, dev)
    expect("dout", dout, (L, N, 2 * H), compute_dtype, dev)
    expect("out", out, (L, N, 2 * H), compute_dtype, dev)
    expect("gates", gates, (2, L, N, 4 * H), compute_dtype, dev)
    return L, N, C, H


def bigru_layer_train_fwd_plain(x, w_ih, b_ih, w_hh, b_hh,
                                compute_dtype=torch.float32):
    """The plain version of K4: step by step with ``models/rnn.py``'s gate
    math. Returns (out (L, N, 2H), gates (2, L, N, 4H)) in the store type."""
    global plain_calls
    L, N, C, H = _check_fwd(x, w_ih, b_ih, w_hh, b_hh, compute_dtype)
    plain_calls += 1
    flat = op(x, compute_dtype).reshape(L * N, C)
    outs, gates = [], []
    for d in (0, 1):
        xg = (flat @ op(w_ih[d], compute_dtype) + b_ih[d]).reshape(L, N, 3 * H)
        w = op(w_hh[d], compute_dtype)
        h = torch.zeros((N, H), dtype=torch.float32, device=x.device)
        ys, gs = [None] * L, [None] * L
        for s in range(L):
            t = s if d == 0 else L - 1 - s
            hg = op(h, compute_dtype) @ w + b_hh[d]
            h, r, z, n = gru_cell(xg[t], hg, h)
            ys[t] = h
            gs[t] = torch.cat([r, z, n, hg[:, 2 * H:]], dim=1)
        outs.append(torch.stack(ys))
        gates.append(torch.stack(gs))
    return (torch.cat(outs, dim=-1).to(compute_dtype),
            torch.stack(gates).to(compute_dtype))


def bigru_layer_bwd_plain(dout, x, w_ih, w_hh, out, gates,
                          compute_dtype=torch.float32):
    """The plain version of K5: the formulas of ``bigru_pallas_vjp.py:10-16``
    step by step on tensors, without autograd. Time walks in reverse per
    direction; h_prev is the stored output one step earlier in the
    direction's own time (zero at its first step). With bf16 operands dxg
    and dhg are rounded to bf16 for the four products and not for the bias
    sums."""
    global plain_calls
    L, N, C, H = _check_bwd(dout, x, w_ih, w_hh, out, gates, compute_dtype)
    plain_calls += 1
    dev = x.device
    f32 = torch.float32
    dx = torch.zeros((L, N, C), dtype=f32, device=dev)
    dw_ih = torch.empty((2, C, 3 * H), dtype=f32, device=dev)
    dw_hh = torch.empty((2, H, 3 * H), dtype=f32, device=dev)
    db_ih = torch.empty((2, 3 * H), dtype=f32, device=dev)
    db_hh = torch.empty((2, 3 * H), dtype=f32, device=dev)
    xs = x.float().reshape(L * N, C)
    for d in (0, 1):
        g = gates[d].float()
        r, z, n, hgn = (g[..., k * H:(k + 1) * H] for k in range(4))
        o = out[..., d * H:(d + 1) * H].float()
        do = dout[..., d * H:(d + 1) * H].float()
        h_prev = torch.zeros_like(o)
        if d == 0:
            h_prev[1:] = o[:-1]
        else:
            h_prev[:-1] = o[1:]
        w_ihT = op(w_ih[d], compute_dtype).T
        w_hhT = op(w_hh[d], compute_dtype).T
        dxg_all = torch.empty((L, N, 3 * H), dtype=f32, device=dev)
        dhg_all = torch.empty((L, N, 3 * H), dtype=f32, device=dev)
        dh = torch.zeros((N, H), dtype=f32, device=dev)
        for s in range(L):
            t = L - 1 - s if d == 0 else s
            dt = do[t] + dh
            dz = dt * (h_prev[t] - n[t]) * z[t] * (1.0 - z[t])
            dn = dt * (1.0 - z[t]) * (1.0 - n[t] * n[t])
            dr = dn * hgn[t] * r[t] * (1.0 - r[t])
            dxg = torch.cat([dr, dz, dn], dim=1)
            dhg = torch.cat([dr, dz, dn * r[t]], dim=1)
            dh = dt * z[t] + op(dhg, compute_dtype) @ w_hhT
            dx[t] += op(dxg, compute_dtype) @ w_ihT
            dxg_all[t] = dxg
            dhg_all[t] = dhg
        dxg_all = dxg_all.reshape(L * N, 3 * H)
        dhg_all = dhg_all.reshape(L * N, 3 * H)
        dw_ih[d] = xs.T @ op(dxg_all, compute_dtype)
        dw_hh[d] = h_prev.reshape(L * N, H).T @ op(dhg_all, compute_dtype)
        db_ih[d] = dxg_all.sum(0)
        db_hh[d] = dhg_all.sum(0)
    return dx, dw_ih, db_ih, dw_hh, db_hh


def bigru_layer_train_fwd(x, w_ih, b_ih, w_hh, b_hh, compute_dtype=torch.float32):
    """K4 on CUDA, the plain version on CPU: (out, gates) in the store type."""
    global launches_fwd
    L, N, C, H = _check_fwd(x, w_ih, b_ih, w_hh, b_hh, compute_dtype)
    if device_of(x) == "cpu":
        return bigru_layer_train_fwd_plain(x, w_ih, b_ih, w_hh, b_hh, compute_dtype)
    cuda_checks((x, w_ih, b_ih, w_hh, b_hh), H)
    r, ty = tile(N, H, x, (2 * H + C) * 4)
    lib = _load()
    out = torch.empty((L, N, 2 * H), dtype=compute_dtype, device=x.device)
    gates = torch.empty((2, L, N, 4 * H), dtype=compute_dtype, device=x.device)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    with torch.cuda.device(x.device):
        rc = lib.bigru_train_fwd_launch(
            DTYPE_CODE[compute_dtype], x.data_ptr(), w_ih.data_ptr(),
            b_ih.data_ptr(), w_hh.data_ptr(), b_hh.data_ptr(), out.data_ptr(),
            gates.data_ptr(), L, N, C, H, r, ty, stream)
    if rc != 0:
        raise RuntimeError("bigru_train_fwd launch failed: cudaError {}".format(rc))
    launches_fwd += 1
    return out, gates


def bigru_layer_bwd(dout, x, w_ih, w_hh, out, gates, compute_dtype=torch.float32):
    """K5 on CUDA, the plain version on CPU: (dx, dw_ih, db_ih, dw_hh, db_hh),
    all f32. The weight gradients are summed without atomics, so two runs on
    the same inputs give bit-equal results."""
    global launches_bwd
    L, N, C, H = _check_bwd(dout, x, w_ih, w_hh, out, gates, compute_dtype)
    if device_of(x) == "cpu":
        return bigru_layer_bwd_plain(dout, x, w_ih, w_hh, out, gates, compute_dtype)
    # transposed, contiguous copies keep the reads along the 3H contraction
    # of dx = dxg W_ih^T and dh = dhg W_hh^T coalesced (a layout change only)
    w_ihT = w_ih.transpose(-1, -2).contiguous()
    w_hhT = w_hh.transpose(-1, -2).contiguous()
    cuda_checks((dout, x, out, gates, w_ihT, w_hhT), H)
    r, ty = tile(N, H, x, 6 * H * 4)
    lib = _load()
    dev = x.device
    f32 = torch.float32
    G = 3 * H
    dx = torch.empty((L, N, C), dtype=f32, device=dev)
    dxg = torch.empty((2, L, N, G), dtype=f32, device=dev)
    dhg = torch.empty_like(dxg)
    # [dW_ih | dW_hh | db_ih | db_hh] in one buffer, returned as views
    sizes = (2 * C * G, 2 * H * G, 2 * G, 2 * G)
    grads = torch.empty(sum(sizes), dtype=f32, device=dev)
    slices = wgrad_slices(L * N, C, H, G, torch.cuda.get_device_properties(
        dev).multi_processor_count)
    part = (torch.empty(slices * grads.numel(), dtype=f32, device=dev)
            if slices > 1 else grads)
    stream = torch.cuda.current_stream(dev).cuda_stream
    with torch.cuda.device(dev):
        rc = lib.bigru_train_bwd_launch(
            DTYPE_CODE[compute_dtype], dout.data_ptr(), x.data_ptr(),
            out.data_ptr(), gates.data_ptr(), w_ihT.data_ptr(),
            w_hhT.data_ptr(), dx.data_ptr(), dxg.data_ptr(), dhg.data_ptr(),
            grads.data_ptr(), part.data_ptr(), slices, L, N, C, H, r, ty, stream)
    if rc != 0:
        raise RuntimeError("bigru_train_bwd launch failed: cudaError {}".format(rc))
    launches_bwd += 1
    dw_ih, dw_hh, db_ih, db_hh = grads.split(sizes)
    return (dx, dw_ih.view(2, C, G), db_ih.view(2, G), dw_hh.view(2, H, G),
            db_hh.view(2, G))


class BiGRULayerFn(torch.autograd.Function):
    """One differentiable BiGRU layer, zero h0: the contract of JAX's
    ``fused_bigru_layer_tm``. Takes x (L, N, C) in compute_dtype and f32
    weights in the stacked layout (w_ih (2, C, 3H), b_ih (2, 3H),
    w_hh (2, H, 3H), b_hh (2, 3H)); returns out (L, N, 2H) f32. The weights
    are rounded to compute_dtype for the kernels and their gradients come
    back in f32, as on the TPU."""

    @staticmethod
    def forward(ctx, x, w_ih, b_ih, w_hh, b_hh, compute_dtype):
        wih = w_ih.detach().to(compute_dtype).contiguous()
        whh = w_hh.detach().to(compute_dtype).contiguous()
        out, gates = bigru_layer_train_fwd(
            x.detach().contiguous(), wih, b_ih.detach().float().contiguous(),
            whh, b_hh.detach().float().contiguous(), compute_dtype)
        ctx.compute_dtype = compute_dtype
        ctx.save_for_backward(x, wih, whh, out, gates)
        return out.float()

    @staticmethod
    def backward(ctx, g):
        x, wih, whh, out, gates = ctx.saved_tensors
        dout = g.to(out.dtype).contiguous()  # the TPU rounds dout alike (:531)
        dx, dw_ih, db_ih, dw_hh, db_hh = bigru_layer_bwd(
            dout, x.contiguous(), wih, whh, out, gates, ctx.compute_dtype)
        return dx, dw_ih, db_ih, dw_hh, db_hh, None


def dropout(x: torch.Tensor, rate: float, generator) -> torch.Tensor:
    """Inverted dropout as the JAX package's (``attrnn.py:53-57``): keep with
    probability 1 - rate and scale kept entries by 1/(1 - rate). The mask is
    drawn from ``generator``; without one, or at rate 0, x passes through."""
    if rate <= 0.0 or generator is None:
        return x
    keep = torch.rand(x.shape, generator=generator, device=x.device) < 1.0 - rate
    return torch.where(keep, x / (1.0 - rate), torch.zeros((), dtype=x.dtype,
                                                            device=x.device))


def birnn_apply_trainable(layers, x: torch.Tensor, compute_dtype=torch.float32,
                          dropout_rate: float = 0.0, generator=None,
                          cell: str = "gru"):
    """Differentiable multi-layer BiGRU on K4/K5 (cell 'gru') or BiLSTM on K6
    ('lstm'), zero h0 (and c0): the port's ``birnn_apply_pallas_trainable``
    (``bigru_pallas_vjp.py:577-616``).

    layers: ``BiRNN.stacked()`` (f32, differentiable). x: (N, L, C). Inter-
    layer dropout (every layer's output but the last) is applied between the
    kernel launches. Returns (out (N, L, 2H) f32, h_n (2*NL, N, H) f32)."""
    layer_fns = {"gru": BiGRULayerFn, "lstm": bilstm_vjp.BiLSTMLayerFn}
    if cell not in layer_fns:
        raise ValueError("cell must be gru or lstm, got {!r}".format(cell))
    H = layers[0][2].shape[1]
    x_tm = x.transpose(0, 1).to(compute_dtype).contiguous()
    h_ns = []
    for li, (wih, bih, whh, bhh) in enumerate(layers):
        out = layer_fns[cell].apply(x_tm, wih, bih, whh, bhh, compute_dtype)
        h_ns += [out[-1, :, :H], out[0, :, H:]]
        x_tm = out
        if li < len(layers) - 1:
            x_tm = dropout(x_tm, dropout_rate, generator)
        x_tm = x_tm.to(compute_dtype)
    return x_tm.transpose(0, 1).float(), torch.stack(h_ns)


def train_fwd_flops(L: int, N: int, C: int, H: int) -> int:
    """Matrix FLOPs of K4 for one layer: per row, step and direction the
    input projection and the recurrent product, 2 (C + H) 3H."""
    return 2 * L * N * 2 * (C + H) * 3 * H


def train_bwd_flops(L: int, N: int, C: int, H: int) -> int:
    """Matrix FLOPs of K5 for one layer: dx and dh (as K4's two products) and
    the two weight gradients of the same sizes: twice K4."""
    return 2 * train_fwd_flops(L, N, C, H)
